"""The weight packing of the population kernels' layer pass
(ops/fused_solve.py::_ring_pack, ring_geometry): what the CUDA ring copies
to shared memory, chunk by chunk, read back here the way
csrc/fused_solve.cu::chunk_at reads it.  Pure PyTorch on the CPU.

For the d1 widths, the tests' (2, 64, 64, 1) and (2, 16, 16, 1) nets and
odd widths, in f32 and bf16: unpacking gives back the layers exactly (bf16:
``_bf16_round`` of them, transposed back), every chunk the kernel copies
starts and ends on a 16-byte boundary, and everything else in the packed
row is zero.
"""

import numpy as np
import pytest
import torch

from ionflux_torch.models import registry as TR
from ionflux_torch.ops import fused_solve as TK

D1 = (2, 200, 200, 200, 200, 200, 200, 1)
WIDTHS = [D1, (2, 64, 64, 1), (2, 16, 16, 1), (2, 37, 130, 1),
          (2, 250, 250, 1)]


def _layers(sizes, members=3, seed=0):
    rs = np.random.RandomState(seed)
    return [(torch.from_numpy(rs.randn(members, a, b).astype(np.float32)),
             torch.from_numpy(rs.randn(members, b).astype(np.float32)))
            for a, b in zip(sizes[:-1], sizes[1:])]


def _round_up(x, m):
    return -(-x // m) * m


def _chunks(sizes, bf16, cap=TK.RING_STAGE_BYTES):
    """Every chunk as the kernel copies it into a stage, one contiguous
    block: (layer, chunk, source offset in elements, rows, elements per
    row), following chunk_at in csrc/fused_solve.cu.  A bf16 row holds the
    chunk's kcc values of k and 8 of padding."""
    geom, _, _ = TK.ring_geometry(list(sizes), bf16, cap)
    for l, (off, kc, nch) in enumerate(geom):
        d_in, d_out = sizes[l], sizes[l + 1]
        for c in range(nch):
            if bf16:
                d8 = _round_up(d_out, 8)
                kcc = min(kc, _round_up(d_in, 16) - c * kc)
                yield (l, c, off + c * d8 * (kc + 8), d8, kcc + 8)
            else:
                cols = _round_up(d_out, 4)
                yield (l, c, off + c * kc * cols, min(kc, d_in - c * kc),
                       cols)


def _unpack(packed, sizes, bf16):
    """The layers [P, in, out] (f32) back from a packed row, and a mask of
    the packed elements they came from."""
    geom, _, _ = TK.ring_geometry(list(sizes), bf16)
    p = packed.shape[0]
    flat = packed.float()
    used = torch.zeros(packed.shape[1], dtype=torch.bool)
    out = [torch.full((p, a, b), float("nan"))
           for a, b in zip(sizes[:-1], sizes[1:])]
    for l, c, src, rows, row_elems in _chunks(sizes, bf16):
        d_in, d_out = sizes[l], sizes[l + 1]
        kc = geom[l][1]
        block = flat[:, src:src + rows * row_elems].reshape(p, rows,
                                                            row_elems)
        if bf16:        # [out8, k] slice of the transposed layer
            k0 = c * kc
            kn = max(0, min(row_elems - 8, d_in - k0))
            out[l][:, k0:k0 + kn, :] = block[:, :d_out, :kn].transpose(1, 2)
            idx = (src + torch.arange(d_out)[:, None] * row_elems
                   + torch.arange(kn)[None, :])
        else:           # k-rows of [in, out4]
            k0 = c * kc
            out[l][:, k0:k0 + rows, :] = block[:, :, :d_out]
            idx = (src + torch.arange(rows)[:, None] * row_elems
                   + torch.arange(d_out)[None, :])
        used[idx.flatten()] = True
    return out, used


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sizes", WIDTHS, ids=lambda s: "x".join(map(str, s)))
def test_ring_pack_unpacks_to_the_layers(sizes, bf16):
    """Unpacked by the kernel's own chunk arithmetic, the packed row gives
    back each layer exactly: the f32 weights, or in bf16 the weights
    rounded as ``_bf16_round`` rounds them (the transpose moves no value)."""
    layers = _layers(sizes)
    packed, geom, stage = TK._ring_pack(layers, bf16)
    assert (geom, stage) == tuple(
        TK.ring_geometry(list(sizes), bf16)[i] for i in (0, 2))
    stride = TK.ring_geometry(list(sizes), bf16)[1]
    assert packed.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(packed.shape) == (3, stride)
    got, _ = _unpack(packed, sizes, bf16)
    for (w, _), wg in zip(layers, got):
        want = TK._bf16_round(w) if bf16 else w
        assert torch.equal(wg, want)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sizes", WIDTHS, ids=lambda s: "x".join(map(str, s)))
def test_ring_chunks_are_16_byte_aligned_and_fit_a_stage(sizes, bf16):
    """A bulk copy moves a multiple of 16 bytes between 16-byte aligned
    addresses: every chunk's source (for any member) and size are 16-byte
    multiples, the chunks of a layer tile its block end to end, and each
    chunk fits the stage the kernel sizes from ring_geometry."""
    esize = 2 if bf16 else 4
    geom, stride, stage = TK.ring_geometry(list(sizes), bf16)
    assert (stride * esize) % 16 == 0
    assert stage % 16 == 0 and stage <= TK.RING_STAGE_BYTES
    n_chunks, end = 0, 0
    for l, c, src, rows, row_elems in _chunks(sizes, bf16):
        assert src == (geom[l][0] if c == 0 else end), (l, c)
        end = src + rows * row_elems
        assert (src * esize) % 16 == 0, (l, c)
        assert (rows * row_elems * esize) % 16 == 0, (l, c)
        assert rows >= 1 and rows * row_elems * esize <= stage, (l, c)
        if bf16:
            assert (row_elems - 8) % 16 == 0    # whole mma k-steps
            # the B-fragment rows of a warp start in distinct bank groups
            words = row_elems // 2
            assert len({(g * words) % 32 for g in range(8)}) == 8
        n_chunks += 1
    assert end == stride
    assert n_chunks == sum(n for _, _, n in geom)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sizes", WIDTHS, ids=lambda s: "x".join(map(str, s)))
def test_ring_padding_is_zero(sizes, bf16):
    """Every element of the packed row that is no weight is zero (a zero
    weight adds nothing to an f32 sum), and the chunks cover the row."""
    layers = _layers(sizes)
    packed, _, _ = TK._ring_pack(layers, bf16)
    _, used = _unpack(packed, sizes, bf16)
    pad = packed.float()[:, ~used]
    assert int(used.sum()) == sum(a * b for a, b in zip(sizes[:-1],
                                                       sizes[1:]))
    assert bool((pad == 0).all())


@pytest.mark.parametrize("sizes", [D1, (2, 250, 250, 1)],
                         ids=["d1", "2x250x250x1"])
def test_ring_chunks_are_balanced(sizes):
    """Chunks of one layer differ by at most one k-row (f32) or one mma
    k-step (bf16), so no chunk is a sliver; the 250-wide layer does not
    divide its chunk depth, the case the card test exercises."""
    for bf16, step in ((False, 1), (True, 16)):
        geom, _, _ = TK.ring_geometry(list(sizes), bf16)
        for l, (_, kc, nch) in enumerate(geom):
            depth = _round_up(sizes[l], 16) if bf16 else sizes[l]
            last = depth - (nch - 1) * kc
            assert 0 < last <= kc and kc - last < nch * step
    geom, _, _ = TK.ring_geometry(list(sizes), False)
    if sizes[1] == 250:
        assert sizes[1] % geom[1][1] != 0


def _setup(entry, sizes, members=2, q=3):
    layers = _layers(sizes, members)
    v = torch.zeros((q, 2000), dtype=torch.float32)
    ts = torch.tensor([0.0, 100.0])
    if entry == "sweep":
        return TK._sweep_setup([(w[0], b[0]) for w, b in layers], TR.HH_B06,
                               v, ts, 0.0, 1.0, None, 1e-5, 1e-7, 256, None)
    if entry == "population":
        return TK._pop_setup(layers, TR.HH_B06, v[0], ts, 0.0, 1.0, None,
                             1e-5, 1e-7, 256)
    return TK._popsweep_setup(layers, TR.HH_B06, v, ts, 0.0, 1.0, None, 1e-5,
                              1e-7, 256, None, None, True, entry == "bf16",
                              1)


@pytest.mark.parametrize("entry,ring", [("sweep", False),
                                        ("population", True),
                                        ("popsweep", True), ("bf16", True)])
def test_entry_point_picks_the_layer_pass(entry, ring):
    """The popsweep (f32 and bf16) and the population solve take the ring
    pass, whatever P is; the sweep its own (the cluster pass, where the net
    fits a cluster: tests/test_torch_cluster.py); the kernel inputs
    follow."""
    s = _setup(entry, (2, 16, 16, 1))
    assert s.ring is ring
    wflat, geom, _, sizes, _, cluster = TK._kernel_inputs(s)
    assert list(sizes) == [2, 16, 16, 1]
    if ring:
        packed, _, _ = TK._ring_pack(s.layers, s.bf16)
        assert torch.equal(wflat, packed) and geom is not None
        assert cluster == (0, None, 0)
    else:
        packed, _, _ = TK._cluster_pack(s.layers, TK.CLUSTER_SIZE)
        assert geom is None and torch.equal(wflat, packed)
        assert cluster[0] == TK.CLUSTER_SIZE


@pytest.mark.parametrize("entry", ["popsweep", "bf16", "population"])
def test_ring_pass_takes_wider_layers(entry):
    """Layers wider than the 256 columns one pass of the ring's threads
    covers: the launch plan keeps the ring pass, names it and the passes
    over each chunk, and the kernel inputs follow with no refusal (the
    card test test_ring_pass_takes_500_wide_members_on_card runs them)."""
    s = _setup(entry, (2, 300, 300, 1), q=16 if entry != "population" else 3)
    row_tile, info = TK.launch_plan(s)
    # one row per block: its 256 threads cover 1,024 columns in one pass
    want = 1 if entry == "population" else 16
    assert info == dict(layer_pass="ring", row_tile=want,
                        column_passes=1 if want == 1 else 2)
    assert row_tile == want
    wflat, geom, bflat, sizes, _, cluster = TK._kernel_inputs(s, row_tile)
    packed, geom_p, stage = TK._ring_pack(
        s.layers, s.bf16, TK._ring_cap(row_tile, [2, 300, 300, 1], s.bf16))
    assert list(sizes) == [2, 300, 300, 1] and cluster == (0, None, 0)
    assert torch.equal(wflat, packed)
    assert list(geom[0]) == list(sum(geom_p, ())) and geom[1] == stage
    assert tuple(bflat.shape) == (2, 601)


WIDE = [D1, (2, 256, 256, 1), (2, 300, 300, 1), (2, 500, 500, 500, 1),
        (2, 800, 800, 1), (2, 960, 960, 1), (2, 2000, 2000, 1),
        (2, 11520, 11520, 1), (2, 28916, 28916, 1), (2, 28917, 28917, 1)]
RING_WIDEST = {False: 11_512, True: 952}    # a (2, w, w, 1) net
BLOCK_SMEM = 232448 - 1024                  # what a launch gives a block


def _shape_only_setup(sizes, q, bf16):
    """A popsweep setup of one member and q rows whose layers are stride-0
    views: launch_plan reads only shapes, so no wide net is allocated."""
    layers = [(torch.zeros(1, 1, 1).expand(1, a, b),
               torch.zeros(1, 1).expand(1, b))
              for a, b in zip(sizes[:-1], sizes[1:])]
    return TK._Setup(layers=layers, vpad=torch.zeros(q, 384),
                     y0=torch.zeros(1, q, 2), gate=(0.0,) * 4, base_a=(),
                     t0=0.0, dt_knot=1.0, t_end=1.0, rtol=1e-5, atol=1e-7,
                     trips=256, block=256, cull=True, bf16=bf16, ring=True)


def _check_mlp_branch(asked, sizes, bf16):
    """launch_plan's second branch, past the ring's rule: mlp() at the
    largest of (asked, 16, 8, 1) whose two row-major activation buffers
    and lane state (8 RT w + 96 RT bytes at the instantiation RT) fit a
    block; past one row's fit (w > 28,916) a ValueError with the
    arithmetic."""
    wmax = max(sizes)
    s = _shape_only_setup(sizes, asked, bf16)
    if 8 * wmax + 96 > BLOCK_SMEM:
        for plan in (lambda: TK.population_pass(asked, list(sizes), bf16),
                     lambda: TK.launch_plan(s)):
            with pytest.raises(ValueError, match="no layer pass"):
                plan()
        assert wmax > 28_916
        return
    rt, info = TK.population_pass(asked, list(sizes), bf16)
    assert info == dict(layer_pass="mlp", row_tile=rt) and rt <= asked
    assert TK.launch_plan(s) == (rt, info)
    inst = next(t for t in (1, 8, 16, 32) if rt <= t)
    assert TK.mlp_smem_bytes(rt, wmax) == 8 * inst * wmax + 96 * inst
    assert TK.mlp_smem_bytes(rt, wmax) <= BLOCK_SMEM
    assert all(TK.mlp_smem_bytes(t, wmax) > BLOCK_SMEM
               for t in (asked, 16, 8) if rt < t <= asked)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sizes", WIDE, ids=lambda s: "x".join(map(str, s)))
def test_ring_row_tile_rule(sizes, bf16):
    """The size rule keeps the asked row tile while the ring's stages, the
    activation buffers and the lane state fit a block at it, else takes the
    largest smaller tile that fits (never 1 in bf16: the mma's rows); every
    layer's smallest chunk fits the capped stage, and the block's shared
    memory at the kernel's instantiation stays under what a block may take.
    The registry's 500-wide nets keep 32 rows.  Past the ring's widest
    layer (11,512 in f32, 952 in bf16) launch_plan takes mlp() instead
    (``_check_mlp_branch``), and past mlp()'s it raises."""
    for asked in (32, 16, 8, 1):
        try:
            rt = TK.ring_row_tile(asked, list(sizes), bf16)
        except ValueError:
            assert max(sizes) > RING_WIDEST[bf16]
            _check_mlp_branch(asked, sizes, bf16)
            continue
        assert TK.launch_plan(_shape_only_setup(sizes, asked, bf16)) == (
            rt, dict(layer_pass="ring", row_tile=rt,
                     column_passes=TK.ring_column_passes(rt, list(sizes),
                                                         bf16)))
        assert rt <= asked and TK.ring_fits(rt, list(sizes), bf16)
        assert all(not TK.ring_fits(t, list(sizes), bf16)
                   for t in (asked, 16, 8) if rt < t <= asked)
        inst = next(t for t in (1, 8, 16, 32)
                    if max(rt, 2 if bf16 else 1) <= t)
        cap = TK._ring_cap(rt, list(sizes), bf16)
        _, _, stage = TK.ring_geometry(list(sizes), bf16, cap)
        act = _round_up(max(sizes), 16) * (1 if inst == 1 else inst + 4)
        smem = (TK.RING_STAGES * stage + 4 * (2 * act + 7 * inst * 2
                                              + 3 * inst * 2 + 2 * inst)
                + 4 * 2 * inst)
        assert stage <= cap and smem <= 232448 - 1024
        for *_, rows, row_elems in _chunks(sizes, bf16, cap):
            assert rows * row_elems * (2 if bf16 else 4) <= stage
        passes = TK.ring_column_passes(rt, list(sizes), bf16)
        assert passes == (1 if max(sizes[1:]) <= 256 else passes) >= 1
    if max(sizes) <= 500:
        assert TK.ring_row_tile(32, list(sizes), bf16) == 32


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("row_tile", [1, 8, 16, 32])
@pytest.mark.parametrize("sizes", [D1, (2, 250, 250, 1), (2, 16, 16, 1)],
                         ids=["d1", "2x250x250x1", "2x16x16x1"])
def test_ring_stages_fit_shared_memory(sizes, row_tile, bf16):
    """The wrapper caps a stage so that the ring's stages, the two
    activation buffers (k-major, [round16(width), RT + 4] f32) and the lane
    state of the kernel's Smem fit the 227 KB a block may take; the chunks
    of the capped geometry fit their stage."""
    cap = TK.ring_stage_cap(row_tile, max(sizes))
    _, _, stage = TK.ring_geometry(list(sizes), bf16, cap)
    rt = next(t for t in (1, 8, 16, 32) if row_tile <= t)
    act = _round_up(max(sizes), 16) * (1 if rt == 1 else rt + 4)
    smem = (TK.RING_STAGES * stage + 4 * (2 * act + 7 * rt * 2
                                          + 3 * rt * 2 + 2 * rt)
            + 4 * 2 * rt)
    assert stage <= cap <= TK.RING_STAGE_BYTES
    assert smem <= 232448 - 1024
    for *_, rows, row_elems in _chunks(sizes, bf16, cap):
        assert rows * row_elems * (2 if bf16 else 4) <= stage
