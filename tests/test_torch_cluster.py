"""The weight packing and the size rule of the sweeps' cluster layer pass
(ops/fused_solve.py::_cluster_pack, cluster_geometry, sweep_cluster): what
each block of a cluster copies into its shared memory, read back here the
way csrc/fused_solve.cu::mlp_cluster reads it.  Pure PyTorch on the CPU.

For the trained d1 widths and odd ones, at clusters of 8 and 16 blocks:
unpacking every rank's row gives back each layer exactly, every slice the
kernel copies starts and ends on a 16-byte boundary, everything else is
zero, and the rule takes the cluster pass exactly where a block's share
fits its shared memory.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ionflux_torch.models import registry as TR
from ionflux_torch.ops import fused_solve as TK

D1 = (2, 200, 200, 200, 200, 200, 200, 1)
WIDE = (2, 512, 512, 512, 512, 512, 1)        # 5 x 512: 5.2 MB of weights
WIDTHS = [D1, (2, 37, 130, 1), (2, 250, 250, 1), (2, 16, 1)]
SIZES = [8, 16]


def _layers(sizes, seed=0):
    rs = np.random.RandomState(seed)
    return [(torch.from_numpy(rs.randn(1, a, b).astype(np.float32)),
             torch.from_numpy(rs.randn(1, b).astype(np.float32)))
            for a, b in zip(sizes[:-1], sizes[1:])]


def _unpack(packed, sizes, csize):
    """Each layer's (W [in, out], b [out]) rebuilt from the ranks' rows by
    mlp_cluster's arithmetic: rank q's hidden slice is W[k][q cols + jl]
    at offset k cols + jl, its bias at in cols + jl; layer 0 and the last
    layer are whole (cols = out, q cols read as 0) in every rank, each rank
    read here in turn.  Also a mask of the packed elements read."""
    geom, _ = TK.cluster_geometry(list(sizes), csize)
    used = torch.zeros(packed.shape, dtype=torch.bool)
    out = []
    for l, (off, cols) in enumerate(geom):
        d_in, d_out = sizes[l], sizes[l + 1]
        w = torch.full((d_in, d_out), float("nan"))
        b = torch.full((d_out,), float("nan"))
        whole = cols >= d_out
        assert whole == (l == 0 or d_out == 1)
        for q in range(csize):
            row = packed[q]
            if whole:
                wq = row[off:off + d_in * cols].reshape(d_in, cols)
                bq = row[off + d_in * cols:off + (d_in + 1) * cols]
                if q:
                    assert torch.equal(wq[:, :d_out], w)
                    assert torch.equal(bq[:d_out], b)
                w, b = wq[:, :d_out].clone(), bq[:d_out].clone()
                used[q, off:off + d_in * cols].view(d_in, cols)[:, :d_out] = (
                    True)
                used[q, off + d_in * cols:off + d_in * cols + d_out] = True
                continue
            for jl in range(cols):
                j = q * cols + jl
                if j >= d_out:
                    continue
                idx = off + torch.arange(d_in) * cols + jl
                w[:, j] = row[idx]
                b[j] = row[off + d_in * cols + jl]
                used[q, idx] = True
                used[q, off + d_in * cols + jl] = True
        out.append((w, b))
    return out, used


@pytest.mark.parametrize("csize", SIZES)
@pytest.mark.parametrize("sizes", WIDTHS, ids=lambda s: "x".join(map(str, s)))
def test_cluster_pack_unpacks_to_the_layers(sizes, csize):
    """Read back rank by rank, the packed rows give every layer's weights
    and biases exactly; every other element is zero."""
    layers = _layers(sizes)
    packed, geom, stride = TK._cluster_pack(layers, csize)
    assert (geom, stride) == TK.cluster_geometry(list(sizes), csize)
    assert packed.dtype == torch.float32
    assert tuple(packed.shape) == (csize, stride)
    got, used = _unpack(packed, sizes, csize)
    for (w, b), (wg, bg) in zip(layers, got):
        assert torch.equal(wg, w[0]) and torch.equal(bg, b[0])
    assert bool((packed[~used] == 0).all())


@pytest.mark.parametrize("csize", SIZES)
@pytest.mark.parametrize("sizes", WIDTHS + [WIDE],
                         ids=lambda s: "x".join(map(str, s)))
def test_cluster_slices_are_16_byte_aligned(sizes, csize):
    """One bulk copy per layer slice moves whole 16-byte words between
    16-byte-aligned addresses: every slice's offset and length in a rank's
    row, and the row itself, are multiples of 4 floats; a slice holds its
    weights and biases, and the slices tile the row end to end."""
    geom, stride = TK.cluster_geometry(list(sizes), csize)
    assert stride % 4 == 0
    ends = [off for off, _ in geom[1:]] + [stride]
    for l, ((off, cols), end) in enumerate(zip(geom, ends)):
        d_in, d_out = sizes[l], sizes[l + 1]
        assert off % 4 == 0 and end % 4 == 0, l
        assert (d_in + 1) * cols <= end - off < (d_in + 1) * cols + 4, l
        step = TK.CLUSTER_COLS if d_out > 1 else 1
        assert cols % step == 0, l
        if l == 0 or d_out == 1:
            assert d_out <= cols < d_out + step
        else:
            assert cols * csize >= d_out > (cols - step) * csize
    assert geom[0][0] == 0


@pytest.mark.parametrize("csize", SIZES)
@pytest.mark.parametrize("row_tile", [8, 16, 32])
def test_size_rule_takes_the_cluster_pass_for_d1(row_tile, csize):
    """d1's slices, exchange buffers and lane state fit a block's 227 KB at
    every row tile and both cluster sizes (105.3 KB of weights at C = 8,
    ~193 KB in all at 32 rows)."""
    smem = TK.cluster_smem_bytes(row_tile, D1, csize)
    assert smem <= 232448 - 1024
    assert TK.sweep_cluster(D1, row_tile, csize) == csize
    _, stride = TK.cluster_geometry(list(D1), csize)
    assert 4 * stride == {8: 107776, 16: 59536}[csize]
    if (row_tile, csize) == (32, 8):
        assert 190_000 < smem < 200_000


@pytest.mark.parametrize("csize", SIZES)
@pytest.mark.parametrize("row_tile", [8, 32])
def test_size_rule_keeps_mlp_for_nets_too_large_or_one_wide(row_tile,
                                                              csize):
    """A 5 x 512 net (5.2 MB) does not fit a cluster: mlp(); nor does a net
    with a hidden layer one wide, whose sum order only mlp() keeps."""
    assert TK.cluster_smem_bytes(row_tile, WIDE, csize) > 232448
    assert TK.sweep_cluster(WIDE, row_tile, csize) == 0
    assert TK.sweep_cluster((2, 16, 1, 16, 1), row_tile, csize) == 0


def _sweep_setup(sizes, b=3, **kw):
    layers = [(w[0], bb[0]) for w, bb in _layers(sizes)]
    v = torch.zeros((b, 2000), dtype=torch.float32)
    s = TK._sweep_setup(layers, TR.HH_B06, v, torch.tensor([0.0, 100.0]),
                        0.0, 1.0, None, 1e-5, 1e-7, 256, None)
    return dataclasses.replace(s, **kw)


@pytest.mark.parametrize("b", [1, 7, 33, 128])
def test_sweep_inputs_follow_the_rule(b):
    """The sweep's kernel inputs: the cluster rows and geometry when the
    rule takes the cluster pass, W0, W1, ... row-major for mlp() (forced,
    or by the rule for the 5 x 512 net); a forced size that does not fit
    raises."""
    row_tile = min(TK.MAX_ROW_TILE, b)
    s = _sweep_setup(D1, b)
    wflat, ring, _, sizes, _, (csize, geom, stride) = TK._kernel_inputs(
        s, row_tile)
    assert ring is None and list(sizes) == list(D1)
    assert csize == TK.CLUSTER_SIZE and stride == wflat.shape[1]
    packed, g, _ = TK._cluster_pack(s.layers, csize)
    assert torch.equal(wflat, packed) and list(geom) == list(sum(g, ()))
    for s_mlp in (dataclasses.replace(s, cluster=0), _sweep_setup(WIDE, b)):
        wflat, _, _, _, _, cl = TK._kernel_inputs(s_mlp, row_tile)
        assert cl == (0, None, 0)
        assert wflat.shape[1] == sum(w.numel() for w, _ in s_mlp.layers)
    wflat, _, _, _, _, cl = TK._kernel_inputs(
        dataclasses.replace(s, cluster=16), row_tile)
    assert cl[0] == 16 and wflat.shape[0] == 16
    with pytest.raises(ValueError, match="cluster pass"):
        TK._kernel_inputs(_sweep_setup(WIDE, b, cluster=8), row_tile)
