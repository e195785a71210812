"""The port's five hand-written CUDA kernels against their plain PyTorch
versions on a card, bit for bit (float lanes as bit patterns, NaN
included). Every test is ``cuda``-marked and skips without a card.

This file imports neither JAX nor the reference package, so it runs on a
machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cms.nscc import NSCCParams
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(2207)

PARAM_SETS = [dict(base_rtt=10.0, max_cwnd=48.0), dict(),
              dict(base_rtt=20.0, md=0.3, max_cwnd=128.0, quick_gain=1.5),
              dict(base_rtt=7.3, target_factor=1.1)]   # target not exact


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _words(shape):
    return RNG.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _sack_rows(n, w):
    ring = _words((n, w))
    for i in range(0, n, 3):
        ring[i, :i % (w + 1)] = 0xFFFFFFFF
    ring[-1] = 0
    if n > 1:
        ring[-2] = 0xFFFFFFFF
    return ring


def _same_bits(got, want):
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", [(1, 2), (2048, 16), (333, 32), (70, 7)])
def test_sack_kernels_match_plain_on_card(cuda, n, w):
    ring, base = _t(_sack_rows(n, w), cuda), _t(_words(n), cuda)
    rtx = _t(_words((n, w)), cuda)
    mask = _t(np.where(RNG.random((n, w)) < 0.3, _words((n, w)), 0)
              .astype(np.uint32), cuda)
    for got, want in zip(ops.sack_fused_cuda(ring, base, rtx, mask),
                         ref.sack_fused_ref(ring, base, rtx, mask)):
        assert _same_bits(got, want)
    for got, want in zip(ops.sack_advance_cuda(ring, base),
                         ref.sack_advance_ref(ring, base)):
        assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("f,w,lanes", [(4, 2, 3), (2048, 16, 9216),
                                       (130, 32, 1000)])
def test_nack_kernel_matches_plain_on_card(cuda, f, w, lanes):
    rtx = _t(_words((f, w)), cuda)
    flow = _t(RNG.integers(-2, f + 2, lanes).astype(np.int32), cuda)
    off = _t(RNG.integers(-4, w * 32 + 8, lanes).astype(np.int32), cuda)
    valid = _t(RNG.integers(0, 2, lanes).astype(bool), cuda)
    assert _same_bits(ops.nack_mark_cuda(rtx, flow, off, valid),
                      ref.nack_mark_ref(rtx, flow, off, valid))


def _nscc_lanes(n, p, device):
    cwnd = RNG.uniform(0.25, p.max_cwnd * 1.2, n).astype(np.float32)
    ecn = RNG.integers(0, 2, n).astype(bool)
    rtt = RNG.uniform(0.0, 6.0 * p.base_rtt, n).astype(np.float32)
    cnt = RNG.integers(-2, 6, n).astype(np.int32)
    edge = np.asarray([0.0, -3.5, np.inf, -np.inf, np.nan,
                       p.base_rtt * p.target_factor, 1e-7, -0.0], np.float32)
    for j, v in enumerate(edge):
        rtt[j::97] = v
    cwnd[3::101], cwnd[5::211] = 0.5, np.nan
    cnt[1::13], cnt[2::13], cnt[4::13] = 0, -9, 1 << 30
    return tuple(_t(a, device) for a in (cwnd, ecn, rtt, cnt))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2048, 100003])
@pytest.mark.parametrize("kw", PARAM_SETS, ids=str)
def test_nscc_kernel_matches_plain_on_card(cuda, n, kw):
    p = NSCCParams(**kw)
    args = _nscc_lanes(n, p, cuda)
    assert _same_bits(ops.nscc_update_cuda(*args, p),
                      ref.nscc_update_ref(*args, p))
    # the entry point takes an int32 ECN lane too
    ecn_i = args[1].to(torch.int32)
    assert _same_bits(ops.nscc_update(args[0], ecn_i, *args[2:], p),
                      ref.nscc_update_ref(*args, p))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7168, 100003])
@pytest.mark.parametrize("fanout", [1, 2, 3, 7, 8, 13, 16, 32])
def test_ecmp_kernel_matches_plain_on_card(cuda, n, fanout):
    lanes = [_t(RNG.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
                .astype(np.int32), cuda) for _ in range(4)]
    assert _same_bits(ops.ecmp_select_cuda(*lanes, fanout),
                      ref.ecmp_hash_ref(*lanes, fanout))
