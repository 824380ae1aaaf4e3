"""K5's launch plan and its cached argument checks, on the CPU.

``_k5_config`` picks the tile of a coupling-stack launch (the lane grid,
BM rows a block, the register tile, the output group, the weight ring);
the sources' shared-memory formulas and compiled instances are mirrored in
``ops/coupling_kernels.py``. The wrapper checks a launch's arguments once
per key (``_key``) and reuses the result."""

import numpy as np
import pytest
import torch

from pocomc_tpu_torch.models.coupling import make_coupling_masks
from pocomc_tpu_torch.ops import coupling_kernels as ck

N_PARAMS = 23
HOPPER_SMEM = 232_448


def _width(d):
    return max(1 << (3 * d - 1).bit_length(), 32)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("n", [1, 37, 256, 1024, 4096, 65_536])
def test_k5_config_fits_a_hopper_block(n, backward):
    """At every d in 2..128 (h = 32 .. 512): the block fits 227 KB, its
    tile is one the kernels are compiled for, its output groups cover the
    transformed half and fit the output tile, the hidden layers fit the
    hidden tile, and a launch has at least 128 blocks wherever n >= 128 *
    8 (the least BM)."""
    instances = ck.k5_instances(backward)
    for d in range(2, 129):
        h = _width(d)
        half = (d + 1) // 2
        cfg = ck._k5_config(n, d, h, backward)
        assert cfg.smem <= HOPPER_SMEM
        assert cfg.smem == 4 * ck._k5_smem_floats(cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G,
                                                  cfg.BK, cfg.S, d, h, backward)
        assert cfg.RL == 4 and cfg.BM in (8, 16, 32, 64) and cfg.BM == 8 * cfg.RM
        assert (cfg.RL, cfg.RM, cfg.RNH, cfg.RNO) in instances
        assert h <= cfg.PW == 32 * cfg.RNH and half <= cfg.PW
        assert 1 <= cfg.G <= half and cfg.G * N_PARAMS <= 32 * cfg.RNO
        assert -(-half // cfg.G) * cfg.G >= half
        assert 2 <= cfg.S <= 8 and cfg.BK % 4 == 0 and 8 <= cfg.BK <= 128
        if n >= 128 * 8:
            assert -(-n // cfg.BM) >= 128


@pytest.mark.parametrize("bins", [2, 5, 12, 16, 17, 32, 64, 128, 1000])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_k5_and_k2_plans_at_bins(backward, bins):
    """With the spline of ``bins`` bins (NP = 3 bins - 1 raw parameters a
    dimension): K5's tile at every d in 2..128 and at d = 171, 342 fits
    227 KB with the NP-wide output groups the kernels' shared-memory
    formula counts, and a group's NP*G columns fit the output tile (past
    16 bins, a group of one dimension may take several output passes:
    coupling_tile.cuh Plan::subs); K2's backward plan (K5's tile on the
    MADE network, every dimension an output) and K2's forward plan fit
    too, at n = 1, 256 and 4096. 1000 bins is the most a spline holds
    (1 - MIN_BIN * bins = 0), and no plan refuses a bins below it."""
    from pocomc_tpu_torch.ops import flow_kernels as fk
    np_ = 3 * bins - 1
    for d in [*range(2, 129), 171, 342]:
        h = _width(d)
        for n in (1, 256, 4096):
            cfg = ck._k5_config(n, d, h, backward, n_params=np_)
            assert cfg.smem <= HOPPER_SMEM
            assert cfg.smem == 4 * ck._k5_smem_floats(cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G,
                                                      cfg.BK, cfg.S, d, h, backward, np_)
            assert 1 <= cfg.G <= (d + 1) // 2
            assert cfg.G * np_ <= cfg.ldo or (bins > fk.FIXED_BINS and cfg.G == 1)
            if backward:
                plan, _ = fk._k2_backward_plan(n, d, h, 2, np_)
                assert plan.smem <= HOPPER_SMEM and 1 <= plan.G <= d
                assert plan.G * np_ <= plan.ldo or (bins > fk.FIXED_BINS and plan.G == 1)
            else:
                P, G, SL = fk._k2_config(n, d, h, np_)
                assert 4 * (P * (d + 2 * h + G * np_ + 1) + 4 + 2 * SL) <= 227 * 1024
                assert 1 <= G <= d and SL >= h + 1


def test_k5_config_tiles_of_the_main_shapes():
    """The bench line runs 64-row blocks (1,024 of them), d=50 at n=4096
    32-row blocks (128), the d=10 training batch 8-row ones."""
    assert ck._k5_config(65_536, 50, 256, False)[:5] == (4, 64, 8, 8, 8)
    assert ck._k5_config(4096, 50, 256, False)[:5] == (4, 32, 4, 8, 8)
    assert ck._k5_config(1024, 10, 32, False)[:6] == (4, 8, 1, 1, 4, 5)
    assert ck._k5_config(1024, 10, 32, True)[:6] == (4, 8, 1, 1, 4, 5)


def test_k5_config_refuses_what_its_tiles_do_not_hold():
    """Past h = 512 a hidden layer runs in passes of 512 columns, on 8-row
    Tiles up to h = 1024 and on Row tiles beyond; only where one row of
    two hidden buffers passes a block's shared memory (h = 32768) does the
    planner raise."""
    for backward in (False, True):
        cfg = ck._k5_config(1024, 171, 1024, backward)
        assert (cfg.RL, cfg.BM, cfg.PW) == (4, 8, 512)
        cfg = ck._k5_config(1024, 5461, 16384, backward)
        assert (cfg.RL, cfg.BM, cfg.PW) == (1, 1, 512)
        with pytest.raises(ValueError, match="shared memory"):
            ck._k5_config(1024, 5462, 32768, backward)
        with pytest.raises(ValueError, match="multiple of 4"):
            ck._k5_config(1024, 10, 34, backward)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("n", [1, 37, 4096])
def test_k5_config_past_h_512(n, backward):
    """At d = 171 .. 5461 (h = 1024 .. 16384): the block fits 227 KB, its
    tile is a compiled instance, hidden layers run in passes of 512
    columns, a Tile of 8 rows where two hidden buffers of 8 rows fit (h =
    1024), a Row of the most rows that fit beyond."""
    instances = ck.k5_instances(backward)
    for d in [171, 200, 341, 342, 500, 682, 683, 1000, 1365, 1366, 2730, 2731, 5461]:
        h = _width(d)
        half = (d + 1) // 2
        cfg = ck._k5_config(n, d, h, backward)
        assert cfg.smem <= HOPPER_SMEM
        assert cfg.smem == 4 * ck._k5_smem_floats(cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G,
                                                  cfg.BK, cfg.S, d, h, backward)
        assert (cfg.RL, cfg.RM, cfg.RNH, cfg.RNO) in instances and cfg.PW == 512
        assert (cfg.RL, cfg.BM) == (4, 8) if h == 1024 else cfg.RL == 1
        if cfg.RL == 1 and cfg.BM < 4:
            bigger = 4 * ck._k5_smem_floats(1, 2 * cfg.BM, cfg.RNH, cfg.RNO, cfg.G, 8, 2, d, h,
                                            backward)
            assert bigger > HOPPER_SMEM
        assert 1 <= cfg.G <= half and cfg.G * N_PARAMS <= cfg.ldo


def _stack(d, T=2, h=32):
    masks = make_coupling_masks(d, T)
    ws, bs = [], []
    for m in masks:
        c = int(m.sum())
        shapes = [(c, h), (h, h), (h, h), (h, (d - c) * N_PARAMS)]
        ws.append([torch.zeros(s) for s in shapes])
        bs.append([torch.zeros(s[1]) for s in shapes])
    return ws, bs, masks


def test_check_cache_key_follows_every_tensor_attribute():
    """A weight at the same address with another shape, dtype or layout,
    another n or other masks gives another key; only the per-call
    tensors' addresses are left out."""
    ws, bs, masks = _stack(4)
    layers = ck._layers(ws, bs)
    x = torch.zeros(5, 4)
    key = ck._key(layers, (x,), masks, 5)
    assert key == ck._key(layers, (torch.ones(5, 4),), masks, 5)
    w = layers[2]
    for other in (w.view(-1), w.view(torch.int32), w.t()):
        assert other.data_ptr() == w.data_ptr()
        swapped = layers[:2] + [other] + layers[3:]
        assert ck._key(swapped, (x,), masks, 5) != key
    assert ck._key(layers, (x,), masks, 6) != key
    assert ck._key(layers, (x.double(),), masks, 5) != key
    assert ck._key(layers, (x,), [~m for m in masks], 5) != key


def test_plan_checks_once_per_key_and_a_wrong_shape_still_raises():
    """``_plan`` runs the checks on a key's first call and reuses them;
    a tensor of a wrong shape makes a new key, whose checks raise."""
    ws, bs, masks = _stack(4)
    layers = ck._layers(ws, bs)
    x = torch.zeros(5, 4)
    calls = []

    def check():
        calls.append(1)
        n, d, h, T = ck._check(x, ws, bs, masks, "coupling_forward")
        ck._check_kernel_layout(masks, d, T, "coupling_forward")
        return n, d, h, T, layers

    key = ck._key(layers, (x,), masks, 5)
    ck._PLANS.pop((False, key), None)
    first = ck._plan(key, check, False)
    assert ck._plan(key, check, False) == first and len(calls) == 1
    assert first[:4] == (5, 4, 32, 2) and first[4] == ck._k5_config(5, 4, 32, False)
    assert first[5] == tuple(a.data_ptr() for a in layers)
    ws[1][3] = torch.zeros(32, 3 * N_PARAMS)
    layers = ck._layers(ws, bs)
    with pytest.raises(ValueError, match="layer shape"):
        ck._plan(ck._key(layers, (x,), masks, 5), check, False)
    assert len(calls) == 2


def test_plan_refuses_weights_off_a_16_byte_boundary():
    ws, bs, masks = _stack(4)
    bs[0][1] = torch.zeros(33)[1:]
    layers = ck._layers(ws, bs)
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="16-byte"):
        ck._plan(ck._key(layers, (x,), masks, 3),
                 lambda: (3, 4, 32, 2, layers), False)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_k5_instances_bound_the_accumulators(backward):
    """Every compiled tile holds at most 64 accumulators a thread, and every
    (RNH, RNO) pair has an 8-row instance."""
    inst = ck.k5_instances(backward)
    for rl, rm, rnh, rno in inst:
        assert rm * ((rnh + rno) if backward else max(rnh, rno)) <= 64
    tiles = {i[1:] for i in inst if i[0] == 4}
    assert {(rnh, rno) for _, rnh, rno in tiles} == set(ck.K5_TILES)
    assert all((1, rnh, rno) in tiles for rnh, rno in ck.K5_TILES)
    assert np.all([rm in (1, 2, 4, 8) for rm, _, _ in tiles])
    assert {i for i in inst if i[0] == 1} == {(1, rm, *ck.K5_ROW) for rm in (1, 2, 4)}


@pytest.mark.parametrize("d,arch", [(22, "nsfc6"), (50, "nsfc6"), (51, "nsfc6"),
                                    (171, "nsfc3")])
def test_packed_weights_follow_the_kernels_layout_and_the_versions(d, arch):
    """``_packed``: every output group's columns, zero-padded to the output
    pass width, and every layer's W^T in passes of PW columns of k (two at
    d=171, h=1024), k zero-padded, where csrc/coupling_tile.cuh ``Packed``
    reads them; kept on the first weight and rebuilt once a weight changes
    in place."""
    from pocomc_tpu_torch.models.flow import Flow
    flow = Flow(d, arch, device="cpu")
    fp = flow.params()
    h, half, T = flow.n_hidden, (d + 1) // 2, len(fp.ws)
    cfg = ck._k5_config(4096, d, h, True)
    layers = ck._layers(fp.ws, fp.bs)
    w3 = ck._packed(layers, fp.ws, cfg, d, h, False)
    wt = ck._packed(layers, fp.ws, cfg, d, h, True)
    ng, PW = -(-half // cfg.G), cfg.PW
    p0, ph = -(-half // PW), -(-h // PW)
    assert tuple(w3.shape) == (T, ng, h, cfg.ldo) and w3.is_contiguous()
    assert tuple(wt.shape) == (T, p0 * h + 2 * ph * h + ph * half * N_PARAMS, PW)
    assert wt.is_contiguous()
    gw = cfg.G * N_PARAMS
    for t in range(T):
        w = fp.ws[t]
        n3 = w[3].shape[1]
        for g in range(ng):
            cols = w[3][:, g * gw:min((g + 1) * gw, n3)]
            assert torch.equal(w3[t, g, :, :cols.shape[1]], cols)
            assert not w3[t, g, :, cols.shape[1]:].any()
        sec = 0
        for l, (passes, rows) in enumerate([(p0, h), (ph, h), (ph, h), (ph, half * N_PARAMS)]):
            full = torch.zeros(rows, passes * PW)
            full[:w[l].shape[1], :w[l].shape[0]] = w[l].T
            for c in range(passes):
                block = wt[t, sec + c * rows:sec + (c + 1) * rows]
                assert torch.equal(block, full[:, c * PW:(c + 1) * PW])
            sec += passes * rows
    assert ck._packed(layers, fp.ws, cfg, d, h, False) is w3
    with torch.no_grad():
        fp.ws[1][3].add_(1.0)
    again = ck._packed(layers, fp.ws, cfg, d, h, False)
    assert again is not w3 and torch.equal(again[1, 0, :, :3], fp.ws[1][3][:, :3])


@pytest.mark.parametrize("n", [1, 37, 256, 504, 505, 1024, 4096])
def test_k5_inverse_backward_plan(n):
    """K5-inv-bwd's plan: a Row of 4 rows where h >= 256 and 8-row Tiles
    would give fewer than 64 blocks (n <= 504), else the backward's own;
    every plan a compiled instance that fits a Hopper block, at d = 2..342."""
    instances = ck.k5_instances(True)
    for d in (2, 10, 20, 50, 51, 128, 171, 342):
        h = _width(d)
        cfg = ck._k5_config(n, d, h, True, inverse=True)
        assert (cfg.RL, cfg.RM, cfg.RNH, cfg.RNO) in instances
        assert cfg.smem <= HOPPER_SMEM
        assert cfg.smem == 4 * ck._k5_smem_floats(cfg.RL, cfg.BM, cfg.RNH, cfg.RNO, cfg.G,
                                                  cfg.BK, cfg.S, d, h, True)
        if h >= 256 and n <= 504:
            assert (cfg.RL, cfg.BM) == (1, 4)
        else:
            assert cfg == ck._k5_config(n, d, h, True)
