"""The port's paged-attention kernel module against the JAX reference.

``sla2_decode_verify_plain`` and ``paged_flash_prefill_plain`` (the
PyTorch versions of the CUDA kernels, and what the wrappers run on a CPU
tensor) are held to the Pallas kernels run in interpret mode, on the same
numpy inputs: routed pages with invalid entries and complete flags,
ragged lengths, quant_bits x kv_quant, n_rep 1 / 2 / 5, a verify window,
and for prefill offset, sliding window, prefix-LM and kv_quant.

Bounds (relative max error): 1e-5 with f32 tiles, 1e-3 with int8 and
1e-2 with fp8 QAT tiles.  Both versions run the same loop; f32 sums in
another order give ~1e-7, and a 1-ulp difference between torch's and
XLA's exp can flip one rounded P code (1/127 of one p for int8, one e4m3
step for fp8).  The pool's int8 / e4m3 codes are made once and handed to
both as the same values, and ``quantize_rows`` is checked bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sla2_decode_paged as JK
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sla2_decode_paged as TK
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BOUND = {"none": 1e-5, "int8": 1e-3, "fp8": 1e-2}
_JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pool(rng, shape, kv_quant):
    """(torch pages, jax pages, torch scale, jax scale): f32 values, or
    int8 / e4m3 codes with per-row scales (codes made once, by the port's
    quantize_rows, and cast exactly on both sides)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if kv_quant == "none":
        return torch.from_numpy(x), jnp.asarray(x), None, None
    codes, scale = tops.quantize_rows(torch.from_numpy(x), kv_quant)
    vals = codes.to(torch.float32).numpy()
    return (codes, jnp.asarray(vals).astype(_JDT[kv_quant]), scale,
            jnp.asarray(scale.numpy()))


def _decode_case(seed, n_rep, w, quant, kv_quant, bk=16, dh=32):
    rng = np.random.default_rng(seed)
    b, hkv, k_sel, n_pages = 2, 2, 4, 12
    kt, kj, kst, ksj = _pool(rng, (n_pages, hkv, bk, dh), kv_quant)
    vt, vj, vst, vsj = _pool(rng, (n_pages, hkv, bk, dh), kv_quant)
    q = rng.standard_normal((b, hkv, w, n_rep, dh)).astype(np.float32)
    phys = rng.integers(1, n_pages, (b, hkv, w, k_sel)).astype(np.int32)
    jlog = rng.integers(0, 5, (b, hkv, w, k_sel)).astype(np.int32)
    valid = (rng.random((b, hkv, w, k_sel)) > 0.25).astype(np.int32)
    valid[..., 0] = 1
    comp = ((rng.random((b, hkv, w, k_sel)) > 0.4) * valid).astype(np.int32)
    t_new = rng.integers(bk, 5 * bk, (b, w)).astype(np.int32)
    h = (rng.random((b, hkv, w, dh, dh)) * 3).astype(np.float32)
    z = (rng.random((b, hkv, w, dh)) * 30 + 5).astype(np.float32)
    alpha = rng.standard_normal((b, hkv, n_rep)).astype(np.float32)
    common = [q, phys, jlog, valid, comp, t_new, h, z, alpha]
    tq, tphys, tjl, tva, tco, ttn, th, tz, ta = (torch.from_numpy(a)
                                                 for a in common)
    jq, jphys, jjl, jva, jco, jtn, jh, jz, ja = (jnp.asarray(a)
                                                 for a in common)
    kw = dict(block_k=bk, quant_bits=quant, kv_quant=kv_quant)
    return ((tq, kt, vt, tphys, tjl, tva, tco, ttn, th, tz, ta),
            dict(kw, k_scale=kst, v_scale=vst),
            (jq, kj, vj, jphys, jjl, jva, jco, jtn, jh, jz, ja),
            dict(kw, k_scale=ksj, v_scale=vsj))


def _single_row(args):
    """Window-shaped decode args (W = 1) as sla2_decode_fused takes them."""
    q, kp, vp, phys, jlog, valid, comp, t_new, h, z, alpha = args
    w0 = lambda a: a[:, :, 0]
    return (w0(q), kp, vp, w0(phys), w0(jlog), w0(valid), w0(comp),
            t_new[:, 0], w0(h), w0(z), alpha)


@pytest.mark.parametrize("quant,kv_quant,n_rep", [
    ("none", "none", 1), ("none", "none", 2), ("none", "none", 5),
    ("none", "int8", 2), ("none", "fp8", 5),
    ("int8", "none", 2), ("int8", "int8", 1), ("int8", "fp8", 5),
    ("fp8", "none", 5), ("fp8", "int8", 2), ("fp8", "fp8", 1)])
def test_decode_plain_matches_pallas(quant, kv_quant, n_rep):
    t_args, t_kw, j_args, j_kw = _decode_case(n_rep, n_rep, 1, quant,
                                              kv_quant)
    jo = JK.sla2_decode_fused(*_single_row(j_args), interpret=True, **j_kw)
    to = TK.sla2_decode_fused(*_single_row(t_args), **t_kw)
    assert to.shape == jo.shape and to.dtype == torch.float32
    assert _rel(to.numpy(), jo) < BOUND[quant]


@pytest.mark.parametrize("quant,kv_quant", [
    ("none", "none"), ("int8", "int8"), ("fp8", "none")])
def test_verify_window_plain_matches_pallas(quant, kv_quant):
    t_args, t_kw, j_args, j_kw = _decode_case(7, 5, 3, quant, kv_quant)
    jo = JK.sla2_decode_verify(*j_args, interpret=True, **j_kw)
    to = TK.sla2_decode_verify(*t_args, **t_kw)
    assert to.shape == jo.shape
    assert _rel(to.numpy(), jo) < BOUND[quant]


def test_decode_row_without_valid_entries_is_defined():
    t_args, t_kw, j_args, j_kw = _decode_case(3, 2, 1, "none", "none")
    t_args = list(t_args)
    t_args[5] = t_args[5].clone()
    t_args[5][0, 0] = 0
    j_args = list(j_args)
    j_args[5] = jnp.asarray(t_args[5].numpy())
    jo = JK.sla2_decode_verify(*j_args, interpret=True, **j_kw)
    to = TK.sla2_decode_verify(*t_args, **t_kw)
    assert np.isfinite(to.numpy()).all()
    assert _rel(to.numpy(), jo) < BOUND["none"]


def _prefill_case(seed, n_rep, c, offset, kv_quant, bk=16, dh=32):
    rng = np.random.default_rng(seed)
    hkv, max_p, n_pages = 2, 16, 20
    kt, kj, kst, ksj = _pool(rng, (n_pages, hkv, bk, dh), kv_quant)
    vt, vj, vst, vsj = _pool(rng, (n_pages, hkv, bk, dh), kv_quant)
    q = rng.standard_normal((hkv * n_rep, c, dh)).astype(np.float32)
    row = np.zeros(max_p, np.int32)
    used = -(-(offset + c) // bk)
    row[:used] = rng.permutation(np.arange(1, n_pages))[:used]
    return ((torch.from_numpy(q), kt, vt, torch.from_numpy(row)),
            dict(k_scale=kst, v_scale=vst),
            (jnp.asarray(q), kj, vj, jnp.asarray(row)),
            dict(k_scale=ksj, v_scale=vsj))


@pytest.mark.parametrize("n_rep,c,offset,window,prefix_len,kv_quant", [
    (2, 32, 0, None, 0, "none"),
    (5, 48, 64, None, 0, "none"),
    (2, 32, 96, 40, 0, "int8"),
    (1, 32, 64, None, 24, "fp8"),
    (2, 16, 96, 20, 24, "none"),
    (5, 32, 128, 24, 48, "int8")])
def test_prefill_plain_matches_pallas(n_rep, c, offset, window, prefix_len,
                                      kv_quant):
    t_args, t_kw, j_args, j_kw = _prefill_case(c + offset, n_rep, c, offset,
                                               kv_quant)
    kw = dict(offset=offset, block_k=16, n_rep=n_rep, window=window,
              prefix_len=prefix_len, kv_quant=kv_quant)
    jo = JK.paged_flash_prefill(*j_args, interpret=True, **kw, **j_kw)
    to = TK.paged_flash_prefill(*t_args, **kw, **t_kw)
    assert to.shape == jo.shape and to.dtype == torch.float32
    assert _rel(to.numpy(), jo) < BOUND["none"]


def test_prefill_compares_valid_rows_of_a_partial_chunk():
    """Rows past chunk_len see whatever the pages hold; the valid rows of a
    partial chunk (the engine's last chunk of a prompt) still agree."""
    t_args, t_kw, j_args, j_kw = _prefill_case(5, 2, 48, 32, "none")
    kw = dict(offset=32, block_k=16, n_rep=2)
    jo = np.asarray(JK.paged_flash_prefill(*j_args, interpret=True, **kw))
    to = TK.paged_flash_prefill(*t_args, **kw).numpy()
    assert _rel(to[:, :20], jo[:, :20]) < BOUND["none"]


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantize_rows_is_bitwise_the_reference(kv_quant):
    x = (np.random.default_rng(0).standard_normal((3, 4, 16, 32)) * 3
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                                    # an all-zero row
    tc, ts = tops.quantize_rows(torch.from_numpy(x), kv_quant)
    jc, js = jops.quantize_rows(jnp.asarray(x), kv_quant)
    np.testing.assert_array_equal(tc.to(torch.float32).numpy(),
                                  np.asarray(jc).astype(np.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tops.dequant_rows(tc, ts).numpy(),
        np.asarray(jops.dequant_rows(jc, js)))
    assert tc.dtype == tops.kv_pool_dtype(kv_quant)
    assert tops.KV_QUANT_MODES == jops.KV_QUANT_MODES


def test_wrappers_reject_what_they_do_not_take():
    t_args, t_kw, _, _ = _decode_case(0, 2, 1, "none", "none")
    bad = list(t_args)
    bad[3] = bad[3].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        TK.sla2_decode_verify(*bad, **t_kw)
    with pytest.raises(ValueError, match="kv_quant"):
        TK.sla2_decode_verify(*t_args, **dict(t_kw, kv_quant="int4"))
    with pytest.raises(ValueError, match="needs"):
        TK.sla2_decode_verify(*t_args, **dict(t_kw, kv_quant="int8"))
    p_args, p_kw, _, _ = _prefill_case(0, 2, 32, 0, "none")
    with pytest.raises(ValueError, match="multiple of block_k"):
        TK.paged_flash_prefill(*p_args, offset=8, block_k=16, n_rep=2)
    with pytest.raises(ValueError, match="block_k"):
        TK._kernel_shape_check("x", 80, 64, 5)


def test_cpu_tensors_take_the_plain_versions_and_leave_the_counts():
    t_args, t_kw, _, _ = _decode_case(1, 2, 2, "int8", "none")
    p_args, _, _, _ = _prefill_case(1, 2, 32, 16, "none")
    before = (TK.sla2_decode_verify.launches, TK.paged_flash_prefill.launches)
    assert torch.equal(TK.sla2_decode_verify(*t_args, **t_kw),
                       TK.sla2_decode_verify_plain(*t_args, **t_kw))
    kw = dict(offset=16, block_k=16, n_rep=2)
    assert torch.equal(TK.paged_flash_prefill(*p_args, **kw),
                       TK.paged_flash_prefill_plain(*p_args, **kw))
    assert (TK.sla2_decode_verify.launches,
            TK.paged_flash_prefill.launches) == before
