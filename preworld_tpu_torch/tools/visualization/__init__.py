"""Occupancy renders (`python -m preworld_tpu_torch.tools.visualization.visual`)."""
