"""The split-and-combine arithmetic of the port's dense decode kernel
against the JAX package.

Without QAT tiles, ``dense_decode`` (csrc/sla2_decode_paged.cu) cuts each
(slot, KV head)'s visible pages into splits, runs the online softmax per
split into partials (acc, m, l) and combines them.  Its plain version,
``dense_decode_split_plain``, is held here to JAX's
``dense_decode_verify`` (the Pallas kernel in interpret mode) on f32 inputs
made from a numpy seed, within 1e-5 relative max error (the combine
rescales each split's partial sums once more than the unsplit loop):
ragged lengths, window and prefix, W 1 and 4, splits of 1 to 5 pages, and
a row that sees nothing, which must give exactly 0.  The card runs the
kernel itself (tests/test_torch_cuda.py); this is the only place where
the combine's -1e30 sentinels meet the reference without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sla2_decode_paged as JK
from repro_torch.kernels import sla2_decode_paged as TK
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BK, DH, HKV, MAX_P = 16, 32, 2, 10


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _case(seed, w, n_rep, lengths):
    rng = np.random.default_rng(seed)
    b, n_pages = len(lengths), 24
    k, v = (rng.standard_normal((n_pages, HKV, BK, DH)).astype(np.float32)
            for _ in range(2))
    q = rng.standard_normal((b, HKV, w, n_rep, DH)).astype(np.float32)
    pt = np.stack([rng.permutation(np.arange(1, n_pages))[:MAX_P]
                   for _ in range(b)]).astype(np.int32)
    # ragged rows of a verify window: lengths + 1 .. lengths + w
    t = (np.asarray(lengths)[:, None] + np.arange(w) + 1).astype(np.int32)
    t[np.asarray(lengths) < 0] = 0                 # rows that see nothing
    return q, k, v, pt, t


def _both(q, k, v, pt, t, pps, **kw):
    jo = JK.dense_decode_verify(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pt),
                                jnp.asarray(t), block_k=BK, interpret=True,
                                **kw)
    to = TK.dense_decode_split_plain(
        *(torch.from_numpy(x) for x in (q, k, v, pt, t)), block_k=BK,
        pages_per_split=pps, **kw)
    return to, np.asarray(jo)


@pytest.mark.parametrize("pps", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("w,n_rep,window,prefix_len", [
    (1, 1, None, 0), (4, 5, None, 0), (1, 2, 40, 0), (4, 2, 40, 24),
    (4, 5, 24, 16)])
def test_split_plain_matches_the_reference(pps, w, n_rep, window,
                                           prefix_len):
    q, k, v, pt, t = _case(pps + 10 * w + n_rep, w, n_rep, (150, 47, 16, 3))
    to, jo = _both(q, k, v, pt, t, pps, window=window, prefix_len=prefix_len)
    assert to.shape == jo.shape and to.dtype == torch.float32
    assert _rel(to, jo) < 1e-5


@pytest.mark.parametrize("w", [1, 4])
def test_split_row_that_sees_nothing_writes_zero(w):
    q, k, v, pt, t = _case(7, w, 2, (90, -1, 31))
    to, jo = _both(q, k, v, pt, t, 2, window=24, prefix_len=8)
    assert torch.equal(to[1], torch.zeros_like(to[1]))
    assert _rel(to, jo) < 1e-5


def test_split_per_slot_pages_match_the_unsplit_plain_version():
    """With pages_per_split per slot, as the kernel takes it, the split
    plain version equals the unsplit one."""
    q, k, v, pt, t = _case(11, 4, 5, (120, 64, 15, 0))
    tk = [torch.from_numpy(x) for x in (q, k, v, pt, t)]
    pps = TK.dense_split_pages(tk[4], BK, MAX_P, n_split=3)
    assert pps == [3, 2, 2, 2]
    to = TK.dense_decode_split_plain(*tk, block_k=BK, pages_per_split=pps)
    want = TK.dense_decode_verify_plain(*tk, block_k=BK)
    assert _rel(to, want) < 1e-5


@pytest.mark.parametrize("b,w,n_rep,max_p,want", [
    (4, 1, 5, 512, (1, 33)), (4, 4, 5, 512, (4, 33)),
    (4, 4, 16, 512, (4, 33)), (3, 4, 5, 64, (4, 32)),
    (1, 1, 1, 8, (1, 4)), (4, 8, 16, 4096, (4, 64)),
    (1, 1, 1, 4096, (1, 128)), (1, 1, 1, 16384, (1, 256))])
def test_split_shape(b, w, n_rep, max_p, want):
    """Rows per block stay within 64; the grid aims at ~8 blocks per SM of
    132; a split never holds more than 64 pages or fewer than 2."""
    assert TK.dense_split_shape(b, 8, w, n_rep, max_p, n_sm=132) == want
