"""The port's occupancy renderer (`preworld_tpu_torch.tools.visualization.
visual`) against `tools/visualization/visual.py`, on the CPU: the 7-view
panel's array pixel for pixel on one seeded grid, the CLI's PNGs equal once
read back, and the open3d viewpoint JSON loader round-trip. Both render
with matplotlib's Agg backend in this process, so equal inputs give equal
pixels."""

import importlib.util
import json
import os

import numpy as np
import pytest

from preworld_tpu_torch.tools.visualization import visual

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VISUAL = os.path.join(REPO, "tools", "visualization", "visual.py")


@pytest.fixture(scope="module")
def jax_visual():
    """`tools/visualization/visual.py`, loaded from its file."""
    spec = importlib.util.spec_from_file_location("jax_visual", JAX_VISUAL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_grid(seed, shape=(200, 200, 16), share=0.05):
    rng = np.random.default_rng(seed)
    sem = np.full(shape, 17, np.uint8)
    occ = rng.random(shape) < share
    sem[occ] = rng.integers(0, 17, occ.sum()).astype(np.uint8)
    sem[:, :, 0] = 11  # ground plane
    return sem


def test_palette_and_rig_equal(jax_visual):
    np.testing.assert_array_equal(visual.COLORS, jax_visual.COLORS)
    assert visual.VIEW_NAMES == jax_visual.VIEW_NAMES
    got, want = visual.builtin_viewpoints(), jax_visual.builtin_viewpoints()
    assert list(got) == list(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)


def test_viewpoint_panel_equal_pixel_for_pixel(jax_visual, tmp_path):
    sem = seeded_grid(1)
    got = visual.render_viewpoint_panel(sem, str(tmp_path / "port.png"))
    want = jax_visual.render_viewpoint_panel(sem, str(tmp_path / "jax.png"))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.std() > 1.0  # it painted something


def test_cli_pngs_equal_once_read_back(jax_visual, tmp_path):
    """`main` over two .npz dumps writes the JAX CLI's files; each PNG
    reads back to the JAX one's pixels."""
    import matplotlib.image as mpimg

    from conftest import run_cli

    pred = tmp_path / "preds"
    pred.mkdir()
    for i in range(2):
        np.savez_compressed(pred / f"{i:06d}.npz",
                            semantics=seeded_grid(i, (20, 20, 8), 0.1))
    outs = {side: tmp_path / side for side in ("jax", "port")}
    run_cli(JAX_VISUAL, [str(pred), "--out-dir", str(outs["jax"])])
    written = visual.main([str(pred), "--out-dir", str(outs["port"])])
    names = sorted(os.listdir(outs["jax"]))
    assert names == ["000000.png", "000001.png"]
    assert sorted(os.path.basename(p) for p in written) == names
    for name in names:
        got = mpimg.imread(outs["port"] / name)
        want = mpimg.imread(outs["jax"] / name)
        np.testing.assert_array_equal(got, want)


def test_viewpoint_json_round_trip(tmp_path):
    """An open3d PinholeCameraParameters file (column-major matrices) of a
    builtin view reads back to that view."""
    R, t, K, W, H = visual.builtin_viewpoints()["front"]
    ext = np.eye(4)
    ext[:3, :3], ext[:3, 3] = R, t
    d = {"class_name": "PinholeCameraParameters",
         "extrinsic": ext.flatten(order="F").tolist(),
         "intrinsic": {"height": H, "width": W,
                       "intrinsic_matrix": K.flatten(order="F").tolist()}}
    path = tmp_path / "cam_front.json"
    path.write_text(json.dumps(d))
    R2, t2, K2, W2, H2 = visual.load_viewpoint_json(str(path))
    np.testing.assert_array_equal(R2, R)
    np.testing.assert_array_equal(t2, t)
    np.testing.assert_array_equal(K2, K)
    assert (W2, H2) == (W, H)
