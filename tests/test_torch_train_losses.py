"""Loss parity of the port's `losses/voxel.py` against
`preworld_tpu/losses/voxel.py` (CPU, f32), values and logit gradients.

Logits (2, 10, 8, 4, 18) N(0, 2); targets uniform over the 18 classes with
some voxels at the CE ignore index 255; a random camera mask where the loss
takes one. The class weights are the JAX package's tables. Tolerance
rtol 1e-5, atol 1e-6 (f32, only the summation order differs). Lovasz sorts
the errors; with continuous logits the only ties are the zero errors of
ignored voxels, whose gradient is zero in both, so the gradient holds to
the same tolerance (at flagship size torch and JAX may order real ties
differently, which moves the gradient, not the loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from preworld_tpu.losses import voxel as jl
from preworld_tpu.models.nerf_head import nusc_class_weights as jax_nusc
from preworld_tpu.models.nerf_head import voxel_class_weights as jax_vcw
from preworld_tpu_torch.losses import voxel as tl

TOL = dict(rtol=1e-5, atol=1e-6)
C = 18


def _case(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (2, 10, 8, 4, C)).astype(np.float32)
    target = rng.integers(0, C, (2, 10, 8, 4)).astype(np.int32)
    target[rng.uniform(size=target.shape) < 0.1] = 255
    cam = rng.uniform(size=target.shape) > 0.3
    return logits, target, cam


def _cls_w():
    return jax_vcw(C, True)


LOSSES = {
    "ce": (lambda f, l, t, c, w: f.ce_ssc_loss(l, t, w), True),
    "focal": (lambda f, l, t, c, w: f.distance_weighted_focal_loss(l, t, w),
              True),
    "focal_cam": (lambda f, l, t, c, w: f.distance_weighted_focal_loss(
        l, t, w, camera_mask=c), True),
    "sem_scal": (lambda f, l, t, c, w: f.sem_scal_loss(l, t), False),
    "sem_scal_cam": (lambda f, l, t, c, w: f.sem_scal_loss(
        l, t, camera_mask=c), False),
    "geo_scal": (lambda f, l, t, c, w: f.geo_scal_loss(l, t,
                                                        non_empty_idx=17),
                 False),
    "lovasz": (lambda f, l, t, c, w: f.lovasz_softmax_loss(
        l, t, ignore_index=17), False),
    "lovasz_cam": (lambda f, l, t, c, w: f.lovasz_softmax_loss(
        l, t, ignore_index=17, camera_mask=c), False),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_and_grad_match_jax(name):
    fn, _ = LOSSES[name]
    logits, target, cam = _case()
    if name.startswith(("geo", "lovasz")):
        target = np.where(target == 255, 17, target)  # no 255 in those
    w = _cls_w()

    def jf(lg):
        return fn(jl, lg, jnp.asarray(target), jnp.asarray(cam),
                  jnp.asarray(w))

    want, want_g = jax.jit(jax.value_and_grad(jf))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = fn(tl, lt, torch.from_numpy(target).long(), torch.from_numpy(cam),
             torch.from_numpy(w))
    (got_g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


def _sem_scal_edge(name):
    """`_case()` with its target or camera mask bent into one of
    sem_scal's edge cases."""
    logits, target, cam = _case()
    if name == "class_absent":  # present 0 for classes 3 and 17
        target = np.where(np.isin(target, (3, 17)), 255, target)
    elif name == "one_class":  # every valid voxel class 5: n_bg 0 there
        target = np.where(target == 255, 255, 5)
    elif name == "all_ignored":  # count 0
        target = np.full_like(target, 255)
    elif name == "all_masked_off":
        cam = np.zeros_like(cam)
    elif name == "mask_zeros":  # half the grid off, and class 2 with it
        cam = cam.copy()
        cam[:, :5] = False
        cam[target == 2] = False
    return logits, target, cam


@pytest.mark.parametrize("name", ["class_absent", "one_class", "all_ignored",
                                  "all_masked_off", "mask_zeros"])
def test_sem_scal_edge_cases_match_jax(name):
    logits, target, cam = _sem_scal_edge(name)
    jc = None if name in ("class_absent", "one_class", "all_ignored") \
        else jnp.asarray(cam)
    want, want_g = jax.jit(jax.value_and_grad(lambda lg: jl.sem_scal_loss(
        lg, jnp.asarray(target), camera_mask=jc)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tl.sem_scal_loss(lt, torch.from_numpy(target).long(),
                           camera_mask=None if jc is None
                           else torch.from_numpy(cam))
    (got_g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    if name in ("all_ignored", "all_masked_off"):
        assert float(got.detach()) == 0.0 and not got_g.any()


class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched under it, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("with_cam", [False, True])
def test_sem_scal_dispatches_under_100_ops(with_cam):
    """One forward and backward of sem_scal_loss dispatches a few dozen
    ops, whatever the number of classes (a loop over the 18 classes
    dispatched ~1,950)."""
    logits, target, cam = _case()
    lt = torch.from_numpy(logits).requires_grad_(True)
    ops = _Ops()
    with ops:
        loss = tl.sem_scal_loss(lt, torch.from_numpy(target).long(),
                                camera_mask=torch.from_numpy(cam)
                                if with_cam else None)
        loss.backward()
    assert 0 < ops.n <= 100


def test_sem_scal_saves_only_its_inputs():
    """The backward's residuals are the logits and target themselves and
    the (C,)-vectors of the formula: no (P, C) or (P,) tensor of its
    own."""
    logits, target, _ = _case()
    lt = torch.from_numpy(logits).requires_grad_(True)
    tt = torch.from_numpy(target).long()
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = (st.nbytes(), t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tl.sem_scal_loss(lt, tt)
    inputs = {t.untyped_storage().data_ptr() for t in (lt, tt)}
    own = [v for k, v in saved.items() if k not in inputs]
    assert all(numel <= 4 * C for _, numel in own)
    inputs_bytes = sum(t.untyped_storage().nbytes() for t in (lt, tt))
    assert sum(b for b, _ in saved.values()) <= inputs_bytes + 64 * C * 4


@pytest.mark.parametrize("num_classes,balance", [(18, True), (18, False),
                                                 (12, True)])
def test_class_weights_match_jax(num_classes, balance):
    np.testing.assert_array_equal(tl.voxel_class_weights(num_classes, balance),
                                  jax_vcw(num_classes, balance))
    np.testing.assert_array_equal(tl.nusc_class_weights(17), jax_nusc(17))
