"""The split-and-combine arithmetic of the port's SLA2 decode kernel
against the JAX package.

Without QAT tiles, ``sla2_decode`` (csrc/sla2_decode_paged.cu) cuts each
(slot, KV head, window row)'s K_sel routed entries into splits of
consecutive entries, runs the online softmax and the linear correction
per split into partials (acc, m, l, lnum, lden) and combines them.  Its
plain version, ``sla2_decode_split_plain``, is held here to JAX's
``sla2_decode_verify`` (the Pallas kernel in interpret mode) on f32 inputs
made from a numpy seed, within 1e-5 relative max error (the combine
rescales each split's softmax partials once more than the unsplit loop,
and lnum / lden are summed per split first): W 1 and 4, n_rep 1 and 5,
splits of 1 up to K_sel entries, complete flags on some, none and all
entries, an empty complement (den under the 1e-4 den_tot threshold),
int8 and fp8 pools, a split whose entries are all invalid, and a row with
no valid entry.  The card runs the kernel itself (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sla2_decode_paged as JK
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sla2_decode_paged as TK
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BK, DH, HKV, K_SEL, N_PAGES = 16, 32, 2, 5, 14
_JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pool(rng, kv_quant):
    """(torch pages, jax pages, torch scale, jax scale): f32 values, or
    int8 / e4m3 codes with per-row scales made once and cast exactly."""
    x = rng.standard_normal((N_PAGES, HKV, BK, DH)).astype(np.float32)
    if kv_quant == "none":
        return torch.from_numpy(x), jnp.asarray(x), None, None
    codes, scale = tops.quantize_rows(torch.from_numpy(x), kv_quant)
    vals = codes.to(torch.float32).numpy()
    return (codes, jnp.asarray(vals).astype(_JDT[kv_quant]), scale,
            jnp.asarray(scale.numpy()))


def _case(seed, w, n_rep, complete="some", kv_quant="none"):
    rng = np.random.default_rng(seed)
    b = 2
    kt, kj, kst, ksj = _pool(rng, kv_quant)
    vt, vj, vst, vsj = _pool(rng, kv_quant)
    q = rng.standard_normal((b, HKV, w, n_rep, DH)).astype(np.float32)
    phys = rng.integers(1, N_PAGES, (b, HKV, w, K_SEL)).astype(np.int32)
    jlog = rng.integers(0, 6, (b, HKV, w, K_SEL)).astype(np.int32)
    valid = (rng.random((b, HKV, w, K_SEL)) > 0.25).astype(np.int32)
    valid[..., 0] = 1
    flags = {"some": rng.random((b, HKV, w, K_SEL)) > 0.4,
             "none": np.zeros((b, HKV, w, K_SEL), bool),
             "all": np.ones((b, HKV, w, K_SEL), bool)}[complete]
    comp = (flags * valid).astype(np.int32)
    t_new = (rng.integers(2 * BK, 6 * BK, (b, 1)) + np.arange(w)).astype(
        np.int32)
    h = (rng.random((b, HKV, w, DH, DH)) * 3).astype(np.float32)
    z = (rng.random((b, HKV, w, DH)) * 30 + 5).astype(np.float32)
    alpha = rng.standard_normal((b, HKV, n_rep)).astype(np.float32)
    arrays = [q, phys, jlog, valid, comp, t_new, h, z, alpha]
    return arrays, (kt, vt, kst, vst), (kj, vj, ksj, vsj), kv_quant


def _both(case, eps):
    arrays, (kt, vt, kst, vst), (kj, vj, ksj, vsj), kv_quant = case
    q, phys, jlog, valid, comp, t_new, h, z, alpha = arrays
    jo = JK.sla2_decode_verify(
        jnp.asarray(q), kj, vj, *(jnp.asarray(a) for a in
                                  (phys, jlog, valid, comp, t_new, h, z,
                                   alpha)),
        block_k=BK, kv_quant=kv_quant, k_scale=ksj, v_scale=vsj,
        interpret=True)
    tq, tphys, tjl, tva, tco, ttn, th, tz, ta = (torch.from_numpy(a)
                                                 for a in arrays)
    to = TK.sla2_decode_split_plain(
        tq, kt, vt, tphys, tjl, tva, tco, ttn, th, tz, ta, block_k=BK,
        entries_per_split=eps, kv_quant=kv_quant, k_scale=kst, v_scale=vst)
    return to, np.asarray(jo)


@pytest.mark.parametrize("eps", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("w,n_rep", [(1, 1), (1, 5), (4, 1), (4, 5)])
def test_split_plain_matches_the_reference(eps, w, n_rep):
    to, jo = _both(_case(eps + 10 * w + n_rep, w, n_rep), eps)
    assert to.shape == jo.shape and to.dtype == torch.float32
    assert _rel(to, jo) < 1e-5


@pytest.mark.parametrize("complete", ["none", "all"])
@pytest.mark.parametrize("eps", [1, 3])
def test_split_plain_complete_flags(complete, eps):
    to, jo = _both(_case(31, 4, 5, complete=complete), eps)
    assert _rel(to, jo) < 1e-5


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
@pytest.mark.parametrize("eps", [2, 5])
def test_split_plain_low_bit_pools(kv_quant, eps):
    to, jo = _both(_case(41, 4, 5, kv_quant=kv_quant), eps)
    assert _rel(to, jo) < 1e-5


@pytest.mark.parametrize("eps", [1, 2, 4])
def test_split_plain_empty_complement(eps):
    """h_tot / z_tot hold exactly the complete routed blocks of each row,
    so phi(q) z_tot - lden falls under the 1e-4 den_tot threshold: o_l is
    0 and a_eff 1 (the output is the sparse branch alone)."""
    arrays, tk, jk, kv_quant = _case(51, 4, 5, complete="all")
    q, phys, jlog, valid, comp, t_new, h, z, alpha = arrays
    kv = tk[0].numpy()
    vv = tk[1].numpy()
    kf = np.exp(kv - kv.max(-1, keepdims=True))
    kf /= kf.sum(-1, keepdims=True)                     # phi(k), f32
    h, z = np.zeros_like(h), np.zeros_like(z)
    for idx in np.ndindex(*phys.shape[:3]):
        for e in range(K_SEL):
            if comp[idx + (e,)]:
                page = kf[phys[idx + (e,)], idx[1]]     # (bk, Dh)
                h[idx] += page.T @ vv[phys[idx + (e,)], idx[1]]
                z[idx] += page.sum(0)
    arrays = [q, phys, jlog, valid, comp, t_new, h, z, alpha]
    case = (arrays, tk, jk, kv_quant)
    to, jo = _both(case, eps)
    assert _rel(to, jo) < 1e-5
    sparse_only = TK.sla2_decode_split_plain(
        *(torch.from_numpy(a) for a in arrays[:1]), tk[0], tk[1],
        *(torch.from_numpy(a) for a in arrays[1:8]),
        torch.full(alpha.shape, 50.0), block_k=BK, entries_per_split=eps)
    assert _rel(to, sparse_only) < 1e-5


@pytest.mark.parametrize("eps", [1, 2, 3])
def test_split_whose_entries_are_all_invalid(eps):
    arrays, tk, jk, kv_quant = _case(61, 4, 5)
    arrays[3] = arrays[3].copy()
    arrays[3][1, 0, :, :eps] = 0                    # the first split of a row
    arrays[3][0, 1, :, eps:2 * eps] = 0             # a middle one
    to, jo = _both((arrays, tk, jk, kv_quant), eps)
    assert _rel(to, jo) < 1e-5


@pytest.mark.parametrize("eps", [1, 2, 5])
def test_row_without_valid_entries_equals_the_reference(eps):
    arrays, tk, jk, kv_quant = _case(71, 4, 5)
    arrays[3] = arrays[3].copy()
    arrays[3][0, 1, 2] = 0
    arrays[4] = arrays[4] * arrays[3]
    to, jo = _both((arrays, tk, jk, kv_quant), eps)
    assert np.isfinite(to.numpy()).all()
    np.testing.assert_allclose(to[0, 1, 2].numpy(), jo[0, 1, 2], rtol=1e-5,
                               atol=1e-6)
    assert _rel(to, jo) < 1e-5


def _unsplit_loop(q, k_pages, v_pages, phys, jlog, valid, complete, t_new,
                  h_tot, z_tot, alpha, *, block_k, quant_bits, k_scale=None,
                  v_scale=None):
    """The plain decode as one ascending loop over the K_sel routed
    entries, frozen as it stood before the kernel was split: the
    reference that one split of ``sla2_decode_split_plain`` must equal."""
    b, hkv, wdw, n_rep, dh = q.shape
    sm_scale = 1.0 / (dh ** 0.5)
    qf32 = q.to(torch.float32)
    qf = TK.phi(qf32)
    if quant_bits != "none":
        q_c, q_s = tops.quantize_tile(qf32, quant_bits)
    h_ix = torch.arange(hkv)[None, :, None]
    t = t_new.to(torch.int64)[:, None, :, None]
    shape = (b, hkv, wdw, n_rep)
    acc = torch.zeros(*shape, dh)
    lnum = torch.zeros(*shape, dh)
    m_i = torch.full(shape, tops.NEG_INF)
    l_i = torch.zeros(shape)
    lden = torch.zeros(shape)
    offs = torch.arange(block_k)
    half_neg = tops.NEG_INF * 0.5
    for jj in range(phys.shape[-1]):
        ph = phys[..., jj].long()
        ok = (valid[..., jj] == 1)[..., None]
        k = TK._dequant(k_pages[ph, h_ix],
                        None if k_scale is None else k_scale[ph, h_ix])
        v = TK._dequant(v_pages[ph, h_ix],
                        None if v_scale is None else v_scale[ph, h_ix])
        if quant_bits == "none":
            s = torch.matmul(qf32, k.transpose(-1, -2)) * sm_scale
        else:
            k_c, k_s = tops.quantize_tile(k, quant_bits)
            s = tops.qdot(q_c, q_s, k_c, k_s, transpose_b=True) * sm_scale
        cols = jlog[..., jj].long()[..., None] * block_k + offs
        s = torch.where((cols < t)[..., None, :], s, tops.NEG_INF)
        m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new > half_neg, m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s > half_neg, p, 0.0)
        corr = torch.exp(torch.where(m_i > half_neg, m_i, m_safe) - m_safe)
        l_new = l_i * corr + TK._tree_sum(p)
        if quant_bits == "none":
            o_tmp = torch.matmul(p, v)
        elif quant_bits == "int8":
            p_c = torch.round(p * tops.INT8_MAX)
            v_c, v_s = tops.quantize_tile(v, "int8")
            o_tmp = tops.qdot(p_c, 1.0 / tops.INT8_MAX, v_c, v_s,
                              transpose_b=False)
        else:
            p_c, p_s = tops.quantize_tile(p, "fp8")
            v_c, v_s = tops.quantize_tile(v, "fp8")
            o_tmp = tops.qdot(p_c, p_s, v_c, v_s, transpose_b=False)
        acc = torch.where(ok[..., None], acc * corr[..., None] + o_tmp, acc)
        m_i = torch.where(ok, m_new, m_i)
        l_i = torch.where(ok, l_new, l_i)
        sub = ok & (complete[..., jj] == 1)[..., None]
        ls = torch.matmul(qf, TK.phi(k).transpose(-1, -2))
        lnum = torch.where(sub[..., None], lnum + torch.matmul(ls, v), lnum)
        lden = torch.where(sub, lden + TK._tree_sum(ls), lden)
    o_s = acc / torch.clamp(l_i, min=1e-20)[..., None]
    den_tot = (qf * z_tot[..., None, :]).sum(dim=-1)
    num = torch.matmul(qf, h_tot) - lnum
    den = den_tot - lden
    den = torch.where(den > 1e-4 * den_tot + 1e-12, den, 0.0)
    o_l = torch.where(den[..., None] > 0,
                      num / torch.clamp(den[..., None], min=1e-12), 0.0)
    a = torch.sigmoid(alpha.to(torch.float32))[:, :, None, :, None]
    a_eff = torch.where(den[..., None] > 0, a, 1.0)
    return a_eff * o_s + (1.0 - a_eff) * o_l


@pytest.mark.parametrize("quant,kv_quant", [
    ("none", "none"), ("int8", "none"), ("fp8", "none"), ("none", "int8")])
def test_one_split_is_the_unsplit_plain_version_bit_for_bit(quant, kv_quant):
    """One split (entries_per_split = K_sel) and the plain versions built
    on it equal the unsplit loop bit for bit: the combine of one split is
    exact (w = exp(0) = 1)."""
    arrays, (kt, vt, kst, vst), _, _ = _case(81, 4, 5, kv_quant=kv_quant)
    ta = [torch.from_numpy(a) for a in arrays]
    args = (ta[0], kt, vt, *ta[1:])
    scales = dict(k_scale=kst, v_scale=vst)
    want = _unsplit_loop(*args, block_k=BK, quant_bits=quant, **scales)
    got = TK.sla2_decode_split_plain(*args, block_k=BK,
                                     entries_per_split=K_SEL,
                                     quant_bits=quant, kv_quant=kv_quant,
                                     **scales)
    assert torch.equal(got, want)
    assert torch.equal(TK.sla2_decode_verify_plain(
        *args, block_k=BK, quant_bits=quant, kv_quant=kv_quant, **scales),
        want)


@pytest.mark.parametrize("b,k_sel,want", [
    (4, 26, (2, 13)), (1, 26, (2, 13)), (16, 26, (3, 9)), (64, 26, (9, 3)),
    (128, 26, (13, 2)), (128, 200, (64, 4)), (1, 500, (4, 125)),
    (2, 3, (2, 2)), (2, 1, (1, 1))])
def test_split_shape(b, k_sel, want):
    """About 8 blocks per SM of 132 over (slot x KV head, split) at one
    window row, no empty split, at least 2 (or K_sel) and at most 64
    entries a split."""
    eps, n_split = TK.decode_split_shape(b, 8, k_sel, n_sm=132)
    assert (eps, n_split) == want
    assert (n_split - 1) * eps < k_sel <= n_split * eps and eps <= 64
