"""The spline of more than 16 bins on the CUDA route, on the CPU: its
launch plans and the weight layouts its kernels read.

Past 16 bins every kernel with a spline head loads the library of run-time
bins (``flow_kernels.lib_bins``): K1 and K1-bwd run the output layer in
groups of 24 columns (``tests/test_torch_inverse.py`` mirrors their ring),
K5 and K2's backward run an output group of one dimension in as many
output passes as its 3 bins - 1 columns take (csrc/coupling_tile.cuh
``Plan::subs``), and each planner sizes its shared memory by the run-time
parameter count. The kernels themselves run on a card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 14); the plain
route's values and gradients at 17-64 bins against the JAX package are in
``tests/test_torch_flow_menu.py``."""

import numpy as np
import pytest
import torch

from pocomc_tpu_torch.ops import coupling_kernels as ck, flow_kernels as fk


def _width(d):
    return max(1 << (3 * d - 1).bit_length(), 32)


# the largest d of each hidden width h = 32 .. 16384, and the menu's d
EDGE_D = sorted({max(d for d in range(2, 5462) if _width(d) == h)
                 for h in (32 << i for i in range(10))} | {3, 10, 50, 171, 342, 683})

PLANNERS = {
    "k5": lambda n, d, h, b: ck._k5_config(n, d, h, False, n_params=3 * b - 1),
    "k5_backward": lambda n, d, h, b: ck._k5_config(n, d, h, True, n_params=3 * b - 1),
    "k5_inverse_backward": lambda n, d, h, b: ck._k5_config(n, d, h, True, n_params=3 * b - 1,
                                                            inverse=True),
    "k2": lambda n, d, h, b: fk._k2_config(n, d, h, 3 * b - 1),
    "k2_backward": lambda n, d, h, b: fk._k2_backward_plan(n, d, h, 2, 3 * b - 1),
    "k1": lambda n, d, h, b: fk._launch_config(n, d, h, "rqs", b),
    "k1_backward": lambda n, d, h, b: fk._backward_config(n, d, h, "rqs", b),
}


def _holds(plan, *args):
    try:
        plan(*args)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_no_plan_refuses_bins_below_1000_where_it_holds_16(name):
    """The ceiling rule: a spline of b bins runs on the card up to the
    smallest b a kernel's plan cannot hold at a (d, n) its 16-bin plan
    holds. No plan refuses any of 17, 32, 64, 128, 256, 512 or 1000 bins
    (the most a spline holds: 1 - MIN_BIN * bins = 0) at the largest d of
    every hidden width and at the menu's d, for n from 1 to 65,536; so no
    ceiling stands below 1000 and ``check_bins`` refuses no bins >= 2."""
    plan = PLANNERS[name]
    for d in EDGE_D:
        h = _width(d)
        for n in (1, 256, 4096, 65_536):
            if not _holds(plan, n, d, h, 16):
                continue
            for bins in (17, 32, 64, 128, 256, 512, 1000):
                assert _holds(plan, n, d, h, bins), (name, d, h, n, bins)
    for bins in (17, 128, 1000, 1001):
        assert fk.check_bins(bins) == bins


@pytest.mark.parametrize("bins", [16, 17, 32, 128, 1000])
def test_library_of_each_bins(bins):
    """A spline of up to 16 bins loads the library compiled for its bins,
    one of more the library of run-time bins (0), whose file name carries
    ``_bN``; the affine head the default one; each bins counts its
    launches under its own name."""
    from pocomc_tpu_torch.ops import _build
    lib = fk.lib_bins(bins)
    assert lib == (bins if bins <= 16 else 0)
    assert fk._lib_bins("affine", bins) == fk.BINS
    name = _build.library_path("ar_inverse", lib).name
    assert name.startswith("libar_inverse_bN-" if bins > 16 else f"libar_inverse_b{bins}-")
    assert ("-DPOCOMC_BINS=0" in _build.flags(0)) and _build.flags(8) == _build.NVCC_FLAGS
    assert fk.launch_attr("rqs", bins) == f"launches_b{bins}"


def test_zero_counts_resets_every_bins_a_wrapper_counted():
    """``zero_counts`` resets the counts of 2-16 bins and of every other
    bins a wrapper has counted (``launches_b32`` once a 32-bin launch
    counted it)."""
    wrapper = fk.ar_inverse
    fk._count(wrapper, "rqs", 32)
    fk._count(wrapper, "rqs", 1000)
    assert wrapper.launches_b32 >= 1 and wrapper.launches_b1000 >= 1
    fk.zero_counts([wrapper])
    assert wrapper.launches_b32 == wrapper.launches_b1000 == wrapper.launches_b16 == 0
    assert wrapper.launches == wrapper.launches_affine == 0


@pytest.mark.parametrize("bins,d", [(32, 10), (128, 10), (128, 51), (1000, 4)])
def test_packed_output_layers_in_passes(bins, d):
    """K5's packed output layers past 16 bins (``_packed``, read as
    csrc/coupling_tile.cuh ``Plan::w3_block`` reads them): each group of
    G = 1 dimension wider than an output pass is ``subs`` blocks of h rows
    of ldo columns, block s holding the group's columns s*ldo.., zero past
    the group's end; every block starts on 16 bytes."""
    from pocomc_tpu_torch.models.flow import Flow
    flow = Flow(d, "nsfc3", bins=bins, device="cpu")
    with torch.no_grad():
        for w in flow.weights:
            w.copy_(torch.randn_like(w))
    fp = flow.params()
    h, half, T, npar = flow.n_hidden, (d + 1) // 2, len(fp.ws), 3 * bins - 1
    cfg = ck._k5_config(4096, d, h, False, n_params=npar)
    gw = cfg.G * npar
    subs = -(-gw // cfg.ldo)
    assert (cfg.G == 1) == (npar > 32 * cfg.RNO) or gw <= cfg.ldo
    w3 = ck._packed(ck._layers(fp.ws, fp.bs), fp.ws, cfg, d, h, False, npar)
    ng = -(-half // cfg.G)
    assert tuple(w3.shape) == (T, ng * subs, h, cfg.ldo) and w3.is_contiguous()
    assert (h * cfg.ldo) % 4 == 0
    for t in range(T):
        n3 = fp.ws[t][3].shape[1]
        for g in range(ng):
            for s in range(subs):
                c0 = g * gw + s * cfg.ldo
                c1 = min(c0 + cfg.ldo, g * gw + gw, n3)
                block = w3[t, g * subs + s]
                torch.testing.assert_close(block[:, :max(c1 - c0, 0)], fp.ws[t][3][:, c0:c1],
                                           rtol=0, atol=0)
                assert not block[:, max(c1 - c0, 0):].any()


@pytest.mark.parametrize("bins,d", [(16, 10), (32, 10), (128, 10), (1000, 3)])
def test_k2_backward_pack_counts_the_output_passes(bins, d):
    """K2's backward pack (``_k2_backward_plan``, the source's PackShape):
    the output layers as ceil(d/G) groups of ``subs`` blocks of h x ldo
    floats, then every W^T in passes of PW columns; ``subs`` is 1 up to 16
    bins, and past them the blocks of a group of one dimension."""
    h, T, npar = _width(d), 2, 3 * bins - 1
    cfg, floats = fk._k2_backward_plan(4096, d, h, T, npar)
    subs = -(-cfg.G * npar // cfg.ldo)
    if bins <= 16:
        assert subs == 1
    else:
        assert cfg.G == 1 or cfg.G * npar <= cfg.ldo
    p0, ph = -(-d // cfg.PW), -(-h // cfg.PW)
    assert floats == T * (-(-d // cfg.G) * subs * h * cfg.ldo
                          + (p0 * h + 2 * ph * h + ph * d * npar) * cfg.PW)
    assert np.all(np.array([cfg.S, cfg.BK]) >= [2, 4])

