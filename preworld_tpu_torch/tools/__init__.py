"""Command-line tools of the port (`python3 -m preworld_tpu_torch.tools.<name>`)."""
