"""The port's CUDA kernels on the card, against their plain versions.

Imports torch and the port only (no JAX), so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the repository's ``tests/conftest.py`` sets up JAX.)
Tests marked ``cuda`` skip without a card. K1 tolerances: f32 (3xTF32 on
the tensor cores) atol 1e-5 on out and lse against the f32 plain version,
with no relative term: out is a convex combination of V's rows (times
1/(1 - rate) with dropout) and lse = m + log(l), so no sum grows with the
sequence (the 3xTF32 products against cuBLAS's f32 ones, an online
against a two-pass softmax, ex2.approx against exp). The bf16
K1 runs its products on the tensor cores with bf16 operands, as JAX's K1
on its hardware: its output is held against the plain version with the same
bf16 roundings (``dots_dtype=torch.bfloat16``) at |kernel - plain| <=
1e-2 (1 + |plain|) (f32 sums in other orders, p rounded to bf16 before
its online softmax's last rescale, and one bf16 rounding of the output)
and against the f32-dots plain version at 2e-2 (1 + |plain|) (one bf16
rounding of every product operand); its lse within 1e-5 (1 + |lse|) of
the bf16-dots plain lse. K2: f32 atol 1e-5 on
dq/dk/dv (the same f32 products summed per thread in key or query order
against cuBLAS's blocked order); bf16 |kernel - plain| <= 2e-2 (1 + |plain|)
(f32 math on both sides, one bf16 rounding of each output, which a last-bit
difference can move by one bf16 step). The bf16 K2 runs its products on
the tensor cores with bf16 operands, as JAX's K2 on its hardware: it is
held against the plain version with the same bf16 roundings
(``dots_dtype=torch.bfloat16``) at |kernel - plain| <= 1e-2 (1 + |plain|)
(f32 sums in other orders, and ds / pd rounded to bf16 from f32 values that
can differ in the last bit), and against the f32-dots plain version at
2e-2 (1 + |plain|) (one bf16 rounding of every product operand). Dropout
runs on the same Philox bits on both sides, so the tolerances hold at rate
0.4 too. K3/K4 (LayerNorm):
y and dx within atol = rtol = 1e-5 (f32) / 2e-2 (bf16), as the JAX
package's own LayerNorm tests; dweight and dbias are sums over every row,
held normwise: max |kernel - plain| <= 1e-5 max |plain|, and bit-equal
from one launch to the next.
"""

import math

import numpy as np
import pytest
import torch

from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt
from multi_modal_foundation_model_tpu_torch.ops import layernorm as tln

torch.set_num_threads(1)

B, T, H, D = 5, 37, 4, 32


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("a CUDA kernel: needs an NVIDIA GPU")


def _operands(case, tk=T):
    """key_pad (B, Tk), static (T, Tk) int32 on the card."""
    rng = np.random.default_rng(0)
    pad = np.ones((B, tk), np.int32)
    pad[1, tk - 9:] = 0
    static = np.zeros((T, tk), np.int32)
    if case == "enc_eye_pad":
        static = np.eye(T, tk, dtype=np.int32)
    elif case == "fully_masked_row":
        pad[2] = 0
    elif case == "random":
        pad = (rng.random((B, tk)) > 0.4).astype(np.int32)
        static = (rng.random((T, tk)) > 0.7).astype(np.int32)
    return (torch.from_numpy(pad).cuda(), torch.from_numpy(static).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["enc_eye_pad", "dec_pad",
                                  "fully_masked_row", "random"])
def test_k1_matches_plain(case, dtype):
    """Through the fused-QKV column views (row stride 3*H*D), lse too;
    T = 37 leaves ragged query and key tiles."""
    _need_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(B, T, 3 * H * D, device="cuda", generator=g).to(dt)
    q, k, v = qkv.split(H * D, dim=-1)
    key_pad, static = _operands(case)
    scale = 1.0 / math.sqrt(D)
    n0 = tatt.K1_LAUNCHES
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                                  with_lse=True)
    torch.cuda.synchronize()
    assert tatt.K1_LAUNCHES == n0 + 1
    assert got.dtype == dt and got.is_contiguous()
    if dt == torch.float32:
        want, want_lse = tatt.attention_reference(q, k, v, key_pad, static,
                                                  H, scale, with_lse=True)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    else:
        _k1_gates(q, k, v, key_pad, static, got, lse)
    atol = 1e-5 if dt == torch.float32 else 2e-2
    if case == "fully_masked_row":         # uniform: the mean of V
        torch.testing.assert_close(
            got[2].float(), v[2].float().mean(0).expand(T, -1), atol=atol,
            rtol=0)


@pytest.mark.cuda
def test_k1_cross_tq_ne_tk():
    _need_cuda()
    tk = 70
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(B, T, H * D, device="cuda", generator=g)
    kv = torch.randn(B, tk, 2 * H * D, device="cuda", generator=g)
    k, v = kv.split(H * D, dim=-1)
    key_pad, static = _operands("random", tk=tk)
    got, _ = tatt.attention_fwd(q, k, v, key_pad, static, H, 0.3)
    want, _ = tatt.attention_reference(q, k, v, key_pad, static, H, 0.3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take():
    _need_cuda()
    q = torch.randn(B, T, H * D, device="cuda")
    key_pad, static = _operands("dec_pad")
    with pytest.raises(TypeError):
        tatt.attention_fwd(q.half(), q.half(), q.half(), key_pad, static, H,
                           1.0)
    wide = torch.randn(B, T, H * 160, device="cuda")
    with pytest.raises(ValueError, match="up to 128"):   # head width 160
        tatt.attention_fwd(wide, wide, wide, key_pad, static, H, 1.0)
    with pytest.raises(ValueError, match="up to 128"):
        tatt.attention_bwd(wide, wide, wide, key_pad, static, wide,
                           torch.zeros(B, H, T, device="cuda"), H, 1.0)
    with pytest.raises(ValueError):              # non-unit inner stride
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        tatt.attention_fwd(qt, q, q, key_pad, static, H, 1.0)
    with pytest.raises(ValueError):              # int64 pad
        tatt.attention_fwd(q, q, q, key_pad.long(), static, H, 1.0)
    with pytest.raises(ValueError):              # dropout needs a seed
        tatt.multi_head_attention(q, q, q, H, dropout_rate=0.1)
    with pytest.raises(TypeError):               # K2: f32 or bf16 only
        qh = q.half()
        tatt.attention_bwd(qh, qh, qh, key_pad, static, qh,
                           torch.zeros(B, H, T, device="cuda"), H, 1.0)
    with pytest.raises(ValueError):              # g in q's dtype
        tatt.attention_bwd(q, q, q, key_pad, static, q.bfloat16(),
                           torch.zeros(B, H, T, device="cuda"), H, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("width", [8, 16, 24, 40, 64, 100, 128])
@pytest.mark.parametrize("length", [70, 257])
def test_k1_k2_head_widths_match_plain(length, width, rate, dtype):
    """K1 and K2 at head widths other than the model's 32: 16, 64 and 128
    compiled, 8, 24, 40 and 100 through heads zero-padded to 16, 32, 64 and
    128; one
    launch each, through the fused-QKV column views, random masks, T = 70
    (ragged tiles) and 257 (past the bf16 wgmma K2's 208 columns at once:
    two chunks, pass A's two sweeps), against the plain versions with the
    dots of the kernel's dtype: f32 (3xTF32) out, lse and dq/dk/dv atol
    1e-5 (K2 rtol 1e-6, as ``_k2_gates``); bf16 out and dq/dk/dv within
    1e-2 (1 + |plain|), lse 1e-5 (1 + |lse|). The padded launches' outputs
    are contiguous at the true width."""
    _need_cuda()
    heads = max(1, 128 // width)
    hidden = heads * width
    gen = torch.Generator(device="cuda").manual_seed(width)
    qkv = torch.randn(3, length, 3 * hidden, device="cuda", generator=gen)
    q, k, v = qkv.to(dtype).split(hidden, dim=-1)
    g = torch.randn(3, length, hidden, device="cuda", generator=gen).to(dtype)
    rng = np.random.default_rng(width)
    pad = (rng.random((3, length)) > 0.3).astype(np.int32)
    pad[0] = 1
    key_pad = torch.from_numpy(pad).cuda()
    static = torch.from_numpy((rng.random((length, length)) > 0.8)
                              .astype(np.int32)).cuda()
    scale = width ** -0.5
    n1, n2 = tatt.K1_LAUNCHES, tatt.K2_LAUNCHES
    out, lse = tatt.attention_fwd(q, k, v, key_pad, static, heads, scale,
                                  True, rate, 13)
    grads = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, heads,
                               scale, rate, 13)
    torch.cuda.synchronize()
    assert (tatt.K1_LAUNCHES - n1, tatt.K2_LAUNCHES - n2) == (1, 1)
    assert out.shape == q.shape and out.is_contiguous()
    want, want_lse = tatt.attention_reference(
        q, k, v, key_pad, static, heads, scale, True, rate, 13,
        dots_dtype=dtype)
    want_g = tatt.attention_bwd_reference(
        q, k, v, key_pad, static, g, lse, heads, scale, rate, 13,
        dots_dtype=dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
        for name, a, b in zip(("dq", "dk", "dv"), grads, want_g):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6,
                                       msg=lambda m, n=name: f"{n}: {m}")
    else:
        _within(out, want, 1e-2, "out")
        _within(lse, want_lse, 1e-5, "lse")
        for name, a, b in zip(("dq", "dk", "dv"), grads, want_g):
            assert a.shape == q.shape and a.is_contiguous(), name
            _within(a, b, 1e-2, name)


@pytest.mark.cuda
def test_model_forward_launches_k1_fifteen_times():
    """A 5+5-layer model's forward runs 15 attentions, each one K1
    launch, and agrees with the plain path (f32, atol 1e-4)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tmm.MultiModalConfig(n_channels={"ap": 30, "behavior": 2},
                               max_F=T, hidden_size=128, n_heads=4,
                               inter_size=256)
    model = tmm.MultiModal(cfg)
    plain = tmm.MultiModal(tmm.MultiModalConfig(
        **{**cfg.to_json_dict(), "avail_mod": cfg.avail_mod,
           "mask_params": cfg.mask_params, "attn_impl": "xla"}))
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(3)
    attn = torch.ones(B, T, dtype=torch.int64, device="cuda")
    attn[-1] = 0
    ts = torch.arange(T, device="cuda").expand(B, T)

    def mi(c):
        x = torch.from_numpy(rng.poisson(1.0, (B, T, c)).astype(np.float32))
        ev = torch.from_numpy((rng.random((B, T, c)) > 0.5).astype(np.int32))
        return tmm.ModalityInput(x.cuda(), x.cuda(), attn, ts, ev.cuda())

    inputs = {"ap": mi(30), "behavior": mi(2)}
    n0 = tatt.K1_LAUNCHES
    with torch.inference_mode():
        out = model(inputs)
        torch.cuda.synchronize()
        assert tatt.K1_LAUNCHES - n0 == 15
        ref = plain(inputs)
    assert tatt.K1_LAUNCHES - n0 == 15
    for mod in ("ap", "behavior"):
        torch.testing.assert_close(out.mod_preds[mod], ref.mod_preds[mod],
                                   atol=1e-4, rtol=0)


def _qkv(case, tk=T, seed=1):
    """q/k/v as column views of a fused QKV (self) or KV (cross) product."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if case == "cross":
        q = torch.randn(B, T, H * D, device="cuda", generator=g)
        kv = torch.randn(B, tk, 2 * H * D, device="cuda", generator=g)
        return (q, *kv.split(H * D, dim=-1))
    qkv = torch.randn(B, T, 3 * H * D, device="cuda", generator=g)
    return qkv.split(H * D, dim=-1)


K2_CASES = [("enc_eye_pad", T), ("fully_masked_row", T), ("cross", 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case", ["enc_eye_pad", "fully_masked_row",
                                  "random"])
def test_k1_dropout_matches_plain(case, rate):
    """K1 at dropout 0 and 0.4 against the plain version on the same
    Philox bits, output and lse."""
    _need_cuda()
    q, k, v = _qkv(case)
    key_pad, static = _operands(case)
    scale = 1.0 / math.sqrt(D)
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                                  with_lse=True, dropout_rate=rate, seed=77)
    want, want_lse = tatt.attention_reference(
        q, k, v, key_pad, static, H, scale, with_lse=True,
        dropout_rate=rate, seed=77)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case,tk", K2_CASES)
def test_k2_matches_plain(case, tk, rate):
    """K2 against ``attention_bwd_reference`` on K1's lse, through the
    fused-projection column views; T = 37 leaves ragged tiles."""
    _need_cuda()
    q, k, v = _qkv(case, tk)
    key_pad, static = _operands("random" if case == "cross" else case, tk)
    scale = 1.0 / math.sqrt(D)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                                with_lse=True, dropout_rate=rate, seed=5)
    g = torch.randn(B, T, H * D, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    n0 = tatt.K2_LAUNCHES
    got = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                             rate, 5)
    torch.cuda.synchronize()
    assert tatt.K2_LAUNCHES == n0 + 1
    want = tatt.attention_bwd_reference(q, k, v, key_pad, static, g, lse,
                                        H, scale, rate, 5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.is_contiguous(), name
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=name)


@pytest.mark.cuda
def test_k2_fully_masked_row_gets_zero_gradient():
    """A padded trial under a pad-only mask: K2 gives its query rows zero
    dq, and its keys zero dk/dv, as JAX's K2 does."""
    _need_cuda()
    q, k, v = _qkv("fully_masked_row")
    key_pad, static = _operands("fully_masked_row")
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, 0.2,
                                with_lse=True)
    g = torch.randn_like(q)
    dq, dk, dv = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, 0.2)
    assert dq[2].abs().max().item() == 0.0
    assert dk[2].abs().max().item() == 0.0
    assert dv[2].abs().max().item() == 0.0
    assert dq[0].abs().max().item() > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_flash_attention_function_kernel_vs_plain(rate):
    """``multi_head_attention`` with grad: K1 + K2 through the autograd
    Function against the plain versions (``impl="xla"``) in it."""
    _need_cuda()
    q, k, v = (t.detach().clone().requires_grad_(True)
               for t in _qkv("enc_eye_pad"))
    key_pad, static = _operands("enc_eye_pad")
    spec = tatt.MaskSpec(key_pad=key_pad, static=static)
    g = torch.randn_like(q)
    grads = []
    for impl in ("pallas", "xla"):
        n1, n2 = tatt.K1_LAUNCHES, tatt.K2_LAUNCHES
        out = tatt.multi_head_attention(q, k, v, H, mask_spec=spec,
                                        dropout_rate=rate, seed=3, impl=impl)
        grads.append((out,) + torch.autograd.grad(out, (q, k, v), g))
        launched = (tatt.K1_LAUNCHES - n1, tatt.K2_LAUNCHES - n2)
        assert launched == ((1, 1) if impl == "pallas" else (0, 0))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _bf16_close(a, b, name=""):
    """|a - b| <= 2e-2 (1 + |b|): bf16 outputs of the same f32 math."""
    torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2,
                               msg=name)


def _within(a, b, tol, name=""):
    """|a - b| <= tol (1 + |b|), elementwise."""
    excess = ((a.float() - b.float()).abs() - tol * (1 + b.float().abs()))
    assert excess.max().item() <= 0.0, (name, excess.max().item())


def _k2_bf16_gates(q, k, v, key_pad, static, g, lse, rate, seed,
                   f32_gate=True, heads=H):
    """The bf16 K2 against the bf16-dots plain version (1e-2) and, with
    ``f32_gate``, the f32-dots one (2e-2); returns the kernel's (dq, dk,
    dv). ``heads``: the operands' heads (the head width is q's columns over
    them)."""
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    n0 = tatt.K2_LAUNCHES
    got = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, heads, scale,
                             rate, seed)
    torch.cuda.synchronize()
    assert tatt.K2_LAUNCHES == n0 + 1
    args = (q, k, v, key_pad, static, g, lse, heads, scale, rate, seed)
    want = tatt.attention_bwd_reference(*args, dots_dtype=torch.bfloat16)
    want_f32 = tatt.attention_bwd_reference(*args)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, want_f32):
        assert a.dtype == torch.bfloat16 and a.is_contiguous(), name
        assert torch.isfinite(a).all(), name
        _within(a, b, 1e-2, name)
        if f32_gate:
            _within(a, c, 2e-2, name)
    return got


def _k2_gates(q, k, v, key_pad, static, g, lse, rate, seed, f32_gate=True,
              heads=H):
    """The tensor-core K2 in q's dtype against its plain version: f32
    (3xTF32) within 1e-5 + 1e-6 |plain| of ``attention_bwd_reference``,
    bf16 as ``_k2_bf16_gates``; returns the kernel's (dq, dk, dv). The f32
    gate is the smoke's 1e-5 at unit magnitudes; its relative term covers
    sums of up to 200 terms in another f32 order (~sqrt(n) 2^-24 relative)
    where they grow large: at Tq = 200, Tk = 1 the 200 queries' g sum to
    |dv| ~ 40, and f32 sums rounded to nearest in the kernel's order miss
    an absolute 1e-5 there too (``tests/test_torch_attention_bwd_f32.py``).

    With one key (Tk = 1) the softmax is constant and dk's exact value is
    0; both sides reach it as a cancellation, dk = sum_q dpn pn (1 - pn)
    qs with pn = exp(s - lse). Pass A recomputes K1's own s (the same
    3xTF32 products of the same operands), but pass B computes s^T and
    (g . v)^T with the operands' roles swapped, another order of the
    truncating sums, and so a few ulps from the s that lse holds; the
    plain version's cuBLAS s is another order again. The kernel's f32 dk
    is then held to that cancellation's scale, sum_q |dpn| |qs| 2^-20
    (|1 - pn| within a few ulps of |s| ~ 1, randn operands), not to the
    plain version's own rounding of it (measured 1.08e-5 where the plain
    version has 4.7e-6 at Tq = 200, dropout 0.4, against the scalar K1's
    lse; the bound is ~1e-4). ``heads``: the operands' heads (the head
    width is q's columns over them)."""
    if q.dtype == torch.bfloat16:
        return _k2_bf16_gates(q, k, v, key_pad, static, g, lse, rate, seed,
                              f32_gate, heads)
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    n0 = tatt.K2_LAUNCHES
    got = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, heads, scale,
                             rate, seed)
    torch.cuda.synchronize()
    assert tatt.K2_LAUNCHES == n0 + 1
    want = tatt.attention_bwd_reference(q, k, v, key_pad, static, g, lse,
                                        heads, scale, rate, seed)
    one_key = k.shape[1] == 1
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.is_contiguous(), name
        if one_key and name == "dk":
            dpn = (tatt._heads(g, heads) * tatt._heads(v, heads)).sum(-1)
            dpn = dpn.abs() / (1.0 - rate)                   # (B, H, Tq)
            qs = tatt._heads(q, heads).abs() * scale         # (B, H, Tq, D)
            bound = 2.0 ** -20 * (dpn[..., None] * qs).sum(2)
            assert (tatt._heads(a, heads)[:, :, 0].abs() <= bound).all(), \
                name
            continue
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6,
                                   msg=lambda m, name=name: f"{name}: {m}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case,tk", K2_CASES)
def test_k2_bf16_matches_plain(case, tk, rate):
    """bf16 q/k/v/g (the bf16 model's operands): K2 writes bf16 dq/dk/dv
    and agrees with the plain version on the same lse and Philox bits. The
    yardstick is now the bf16-dots plain version (the tensor-core K2 rounds
    its product operands to bf16 as JAX's hardware K2 does), with the
    f32-dots one still within 2e-2 (1 + |plain|)."""
    _need_cuda()
    q, k, v = (t.bfloat16() for t in _qkv(case, tk))
    key_pad, static = _operands("random" if case == "cross" else case, tk)
    scale = 1.0 / math.sqrt(D)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                                with_lse=True, dropout_rate=rate, seed=5)
    g = torch.randn(B, T, H * D, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    g = g.bfloat16()
    got = _k2_bf16_gates(q, k, v, key_pad, static, g, lse, rate, 5)
    if case == "fully_masked_row":
        assert got[0][2].abs().max().item() == 0.0


def _problem(tq, tk, seed=4, b=3, dtype=torch.bfloat16, hidden=H * D):
    """q (column view of a fused QKV when self-attention, else its own
    tensor), k/v views of a fused KV, random masks, g, at Tq x Tk, in
    ``dtype``, ``hidden`` columns (H heads of D unless given)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if tq == tk:
        qkv = torch.randn(b, tq, 3 * hidden, device="cuda", generator=gen)
        q, k, v = qkv.to(dtype).split(hidden, dim=-1)
    else:
        q = torch.randn(b, tq, hidden, device="cuda", generator=gen).to(dtype)
        kv = torch.randn(b, tk, 2 * hidden, device="cuda", generator=gen)
        k, v = kv.to(dtype).split(hidden, dim=-1)
    rng = np.random.default_rng(seed)
    pad = (rng.random((b, tk)) > 0.3).astype(np.int32)
    pad[0] = 1
    static = (rng.random((tq, tk)) > 0.8).astype(np.int32)
    g = torch.randn(b, tq, hidden, device="cuda", generator=gen).to(dtype)
    return (q, k, v, torch.from_numpy(pad).cuda(),
            torch.from_numpy(static).cuda(), g)


# both dtypes of K2; the tests below keep the names they had when they
# held the bf16 kernel alone
K2_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(1, 1), (17, 17), (63, 63), (64, 64),
                                   (65, 65), (70, 70), (200, 200), (65, 200),
                                   (200, 17), (1, 200), (200, 1), (63, 65),
                                   (256, 256), (257, 257), (200, 300),
                                   (520, 520), (300, 17)])
def test_k2_bf16_tensor_cores_at_tile_edges(tq, tk, rate, dtype):
    """The tensor-core K2 (f32: 3xTF32; bf16) at lengths below, at and past
    its 64-row tiles (200 = 3 x 64 + 8, the model's), self and cross, and
    past the bf16 wgmma kernel's 208 columns at once (256 and up: two or
    three chunks, pass A sweeping them twice). The
    bf16 kernel is held against the bf16-dots plain version only: at Tk = 1
    the f32 softmax is exactly 1 and the f32-dots ds exactly 0, while q *
    scale rounded to bf16 moves s off K1's lse by up to 2^-8 |s|, and ds by
    that times |g . v| (~2e-2 in dq here), as on JAX's hardware K2."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(tq, tk, dtype=dtype)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H,
                                1.0 / math.sqrt(D), with_lse=True,
                                dropout_rate=rate, seed=21)
    _k2_gates(q, k, v, key_pad, static, g, lse, rate, 21, f32_gate=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k2_bf16_blocks_walking_several_heads(rate, dtype):
    """At B = 256 a block of the tensor-core K2 walks all 4 heads of its
    (batch, row tile), redrawing the keep bits per head; the smaller tests
    run one head a block."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(200, 200, seed=7, b=256,
                                           dtype=dtype)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H,
                                1.0 / math.sqrt(D), with_lse=True,
                                dropout_rate=rate, seed=13)
    _k2_gates(q, k, v, key_pad, static, g, lse, rate, 13)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k2_bf16_padded_trial_zero_and_bit_equal(rate, dtype):
    """A padded trial (every key masked, pad-only mask) gets exactly zero
    dq, dk and dv; and two launches give the same bits (no atomics)."""
    _need_cuda()
    q, k, v, key_pad, _, g = _problem(200, 200, seed=6, dtype=dtype)
    key_pad[1] = 0
    static = torch.zeros(200, 200, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(D)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                                with_lse=True, dropout_rate=rate, seed=8)
    one = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                             rate, 8)
    two = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                             rate, 8)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
        assert a[1].abs().max().item() == 0.0
        assert a[0].abs().max().item() > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(200, 200), (257, 257), (300, 17)])
def test_k2_bf16_draw_offset_matches_plain_and_bit_equal(tq, tk, rate):
    """The bf16 K2 of a rank's slice, draw offsets (b0, h0) = (5, 3):
    against the plain version drawn at the same offsets (1e-2 (1 +
    |plain|), ``_within``), and a second launch bit-equal to the first
    (fixed-order sums, no atomics), in one chunk and across chunks."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(tq, tk, seed=12)
    scale, off = 1.0 / math.sqrt(D), (5, 3)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                                rate, 31, draw_offset=off)
    got = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                             rate, 31, draw_offset=off)
    again = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                               rate, 31, draw_offset=off)
    want = tatt.attention_bwd_reference(q, k, v, key_pad, static, g, lse, H,
                                        scale, rate, 31,
                                        dots_dtype=torch.bfloat16,
                                        draw_offset=off)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        _within(a, b, 1e-2, name)
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=str)
def test_k2_bf16_rejects_misaligned_views(dtype):
    """cp.async copies 16 bytes: a view whose data pointer or row stride is
    not 16-byte aligned raises ValueError, in f32 as in bf16."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(17, 17, dtype=dtype)
    lse = torch.zeros(3, H, 17, device="cuda")
    half = 8 // q.element_size()                   # half a 16-byte chunk
    wide = torch.zeros(3, 17, H * D + 8, device="cuda", dtype=dtype)
    off = wide[..., 1:1 + H * D]                   # pointer one element off
    odd = torch.zeros(3, 17, H * D + half, device="cuda", dtype=dtype)
    odd = odd[..., :H * D]                         # row stride 8 bytes off
    for bad in (off, odd):
        with pytest.raises(ValueError):
            tatt.attention_bwd(bad, k, v, key_pad, static, g, lse, H, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_bwd(q, bad, v, key_pad, static, g, lse, H, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_bwd(q, k, v, key_pad, static, bad, lse, H, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=str)
@pytest.mark.parametrize("q0", [0, 77, 199])
def test_k2_bf16_pass_b_keep_bits_read_back(q0, dtype):
    """Read pass B's staged keep bits back: q = k = 0 and every key
    attended make every probability 1/Tk; v = 0 and g one-hot at query q0
    (ones over its D) make dv[b, k, h*D + d] = ms(q0, k) / Tk, so dv > 0
    exactly where Philox keeps (b, h, q0, k). rtol: one bf16 rounding of
    dv, or ex2.approx's ~2 ulp in f32."""
    _need_cuda()
    tq = tk = 200
    rate, seed = 0.4, 987654321
    q = torch.zeros(B, tq, H * D, device="cuda", dtype=dtype)
    k = torch.zeros(B, tk, H * D, device="cuda", dtype=dtype)
    g = torch.zeros(B, tq, H * D, device="cuda")
    g[:, q0] = 1.0
    g = g.to(dtype)
    key_pad = torch.ones(B, tk, dtype=torch.int32, device="cuda")
    static = torch.zeros(tq, tk, dtype=torch.int32, device="cuda")
    _, lse = tatt.attention_fwd(q, k, k, key_pad, static, H, 1.0,
                                with_lse=True, dropout_rate=rate, seed=seed)
    _, _, dv = tatt.attention_bwd(q, k, k, key_pad, static, g, lse, H, 1.0,
                                  rate, seed)
    dv = dv.float().reshape(B, tk, H, D).transpose(1, 2)      # (B, H, Tk, D)
    keep = tatt.philox_keep(seed, B, H, tq, tk, rate, device="cuda")[:, :, q0]
    want = keep.float()[..., None] / (1 - rate) / tk
    rtol = 4e-3 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dv, want.expand_as(dv), atol=0, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k1_bf16_dropout_lse_matches_plain(rate):
    """The bf16 training forward: K1 on bf16 q/k/v with dropout and lse."""
    _need_cuda()
    q, k, v = (t.bfloat16() for t in _qkv("enc_eye_pad"))
    key_pad, static = _operands("enc_eye_pad")
    scale = 1.0 / math.sqrt(D)
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                                  with_lse=True, dropout_rate=rate, seed=11)
    assert got.dtype == torch.bfloat16
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 11)


def _k1_gates(q, k, v, key_pad, static, got, lse, rate=0.0, seed=0,
              heads=None, draw_offset=(0, 0)):
    """The tensor-core K1 in q's dtype against its plain version: f32
    (3xTF32) out and lse within atol 1e-5 of ``attention_reference`` (the
    module's note says why no relative term); bf16 out within 1e-2 (1 +
    |plain|) of the bf16-dots plain version and 2e-2 (1 + |plain|) of the
    f32-dots one, its lse within 1e-5 (1 + |lse|) of the bf16-dots plain
    lse. ``heads``: the operands' heads (H heads of D unless given; the
    head width is q's columns over them)."""
    h = heads or q.shape[-1] // D
    args = (q, k, v, key_pad, static, h, 1.0 / math.sqrt(q.shape[-1] // h),
            True, rate, seed)
    assert got.dtype == q.dtype and got.is_contiguous()
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    if q.dtype == torch.float32:
        want, want_lse = tatt.attention_reference(*args,
                                                  draw_offset=draw_offset)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0, msg="out")
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0,
                                   msg="lse")
        return
    want, want_lse = tatt.attention_reference(*args,
                                              dots_dtype=torch.bfloat16,
                                              draw_offset=draw_offset)
    _within(got, want, 1e-2, "out")
    _within(lse, want_lse, 1e-5, "lse")
    _within(got, tatt.attention_reference(
        *args, draw_offset=draw_offset)[0], 2e-2, "out f32")


# both dtypes of the tensor-core K1
K1_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(1, 1), (17, 17), (64, 64), (65, 65),
                                   (70, 70), (200, 200), (65, 200),
                                   (200, 17)])
def test_k1_tensor_cores_at_tile_edges(tq, tk, rate, dtype):
    """The tensor-core K1 (f32: 3xTF32; bf16) at lengths below, at and past
    its 64-row tiles (200 = 3 x 64 + 8, the model's), through the fused-QKV
    (self) or KV (cross) column views, random masks, with lse."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(tq, tk, dtype=dtype)
    n0 = tatt.K1_LAUNCHES
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H,
                                  1.0 / math.sqrt(D), with_lse=True,
                                  dropout_rate=rate, seed=31)
    torch.cuda.synchronize()
    assert tatt.K1_LAUNCHES == n0 + 1
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 31)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k1_blocks_walking_several_heads(rate, dtype):
    """At B = 256 a block of the tensor-core K1 walks all 4 heads of its
    (batch, row tile): the f32 kernel draws the next head's keep bits
    beside the current head's products, the bf16 wgmma kernel brings each
    head's keep bytes by TMA into one of its two stages; the smaller tests
    run one head a block."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(200, 200, seed=7, b=256,
                                           dtype=dtype)
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H,
                                  1.0 / math.sqrt(D), with_lse=True,
                                  dropout_rate=rate, seed=17)
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k1_fully_masked_row_and_bit_equal(rate, dtype):
    """A padded trial (every key masked, pad-only mask): its rows are the
    mean of V (of the kept V / (1 - rate) with dropout; bf16: 1/(1 - rate)
    rounded to bf16 as pd is) within 1e-5 (f32) or 1e-2 (1 + |mean|)
    (bf16), and their lse is -1e6 + log(Tk); two launches give the same
    bits."""
    _need_cuda()
    q, k, v, key_pad, _, _ = _problem(200, 200, seed=6, dtype=dtype)
    key_pad[1] = 0
    static = torch.zeros(200, 200, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(D)
    one = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                             with_lse=True, dropout_rate=rate, seed=8)
    two = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                             with_lse=True, dropout_rate=rate, seed=8)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    got, lse = one
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 8)
    floor = torch.tensor(-1e6) + torch.log(torch.tensor(200.0))
    torch.testing.assert_close(lse[1].cpu(), floor.expand(H, 200), atol=0.07,
                               rtol=0)
    vh = v[1].float().reshape(200, H, D).transpose(0, 1)    # (H, Tk, D)
    if rate > 0.0:
        keep = tatt.philox_keep(8, 2, H, 200, 200, rate, device="cuda")[1]
        scale_kept = torch.tensor(1.0 / (1.0 - rate)).to(dtype).float()
        mean = (keep.float() * scale_kept) @ vh / 200     # (H, Tq, D)
    else:
        mean = vh.mean(1, keepdim=True).expand(H, 200, D)
    row = got[1].float().reshape(200, H, D).transpose(0, 1)
    if dtype == torch.float32:
        torch.testing.assert_close(row, mean, atol=1e-5, rtol=0)
    else:
        _within(row, mean, 1e-2, "padded trial")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
def test_k1_rejects_misaligned_views(dtype):
    """cp.async copies 16 bytes: a view whose data pointer or row stride is
    not 16-byte aligned raises ValueError, in f32 as in bf16."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(17, 17, dtype=dtype)
    half = 8 // q.element_size()                   # half a 16-byte chunk
    wide = torch.zeros(3, 17, H * D + 8, device="cuda", dtype=dtype)
    off = wide[..., 1:1 + H * D]                   # pointer one element off
    odd = torch.zeros(3, 17, H * D + half, device="cuda", dtype=dtype)
    odd = odd[..., :H * D]                         # row stride 8 bytes off
    n0 = tatt.K1_LAUNCHES
    for bad in (off, odd):
        with pytest.raises(ValueError):
            tatt.attention_fwd(bad, k, v, key_pad, static, H, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_fwd(q, bad, v, key_pad, static, H, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_fwd(q, k, bad, key_pad, static, H, 1.0)
    assert tatt.K1_LAUNCHES == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
def test_k1_philox_bits_match_philox_keep(dtype):
    """Read the tensor-core K1's keep mask back: q = 0 and all keys
    attended make every probability 1 (before 1/l = 1/Tk); V's rows are
    one-hot per head (Tk = D = 32), so out[b, q, h*D + k] > 0 exactly where
    Philox keeps (b, h, q, k)."""
    _need_cuda()
    tk, rate, seed = D, 0.4, 123456789
    q = torch.zeros(B, T, H * D, device="cuda", dtype=dtype)
    v = torch.eye(D, device="cuda").repeat(1, H).expand(B, tk, H * D)
    v = v.contiguous().to(dtype)
    k = torch.zeros(B, tk, H * D, device="cuda", dtype=dtype)
    key_pad = torch.ones(B, tk, dtype=torch.int32, device="cuda")
    static = torch.zeros(T, tk, dtype=torch.int32, device="cuda")
    out, _ = tatt.attention_fwd(q, k, v, key_pad, static, H, 1.0,
                                dropout_rate=rate, seed=seed)
    got = out.float().reshape(B, T, H, D).transpose(1, 2) > 0
    want = tatt.philox_keep(seed, B, H, T, tk, rate, device="cuda")
    assert torch.equal(got, want)
    assert 0.5 < want.float().mean().item() < 0.7


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(207, 207), (208, 208), (209, 209),
                                   (111, 111), (112, 112), (113, 113),
                                   (225, 225), (257, 257), (520, 520),
                                   (200, 300), (300, 17)])
def test_k2_f32_wgmma_at_chunk_edges(tq, tk, rate):
    """The f32 wgmma K2 (3xTF32) around its chunks: pass A's 208 keys (one
    sweep up to 208, two past it), pass B's 112 queries at D = 32 (one
    chunk up to 112, two or more past it), and its 64-row tiles, self and
    cross, through the fused-QKV or KV column views, random masks: against
    the f32 plain version at atol 1e-5 (``_k2_gates``)."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(tq, tk, seed=tq + tk,
                                           dtype=torch.float32)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H,
                                1.0 / math.sqrt(D), with_lse=True,
                                dropout_rate=rate, seed=43)
    _k2_gates(q, k, v, key_pad, static, g, lse, rate, 43)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(200, 200), (257, 257), (300, 17)])
def test_k2_f32_draw_offset_matches_plain_and_bit_equal(tq, tk, rate):
    """The f32 K2 of a rank's slice, draw offsets (b0, h0) = (5, 3):
    against the f32 plain version drawn at the same offsets (atol 1e-5 +
    1e-6 |plain|, as ``_k2_gates``), and a second launch bit-equal to the
    first (fixed-order sums, no atomics), in one chunk and across chunks."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(tq, tk, seed=12,
                                           dtype=torch.float32)
    scale, off = 1.0 / math.sqrt(D), (5, 3)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                                rate, 31, draw_offset=off)
    got = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                             rate, 31, draw_offset=off)
    again = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                               rate, 31, draw_offset=off)
    want = tatt.attention_bwd_reference(q, k, v, key_pad, static, g, lse, H,
                                        scale, rate, 31, draw_offset=off)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6, msg=name)
        assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=str)
@pytest.mark.parametrize("width", [32, 128])
def test_k2_launches_as_a_new_threads_first_cuda_work(width, dtype):
    """The wgmma kernels encode their TMA tensor maps through the driver
    API, which needs a context current on the calling thread, and
    autograd's device thread can reach K2 before any other CUDA call binds
    one there (``test_flash_attention_function_kernel_vs_plain`` did). K2
    launched as the first CUDA work of a new thread, without dropout (no
    seed copied to the card first), gives this thread's result bit for
    bit."""
    _need_cuda()
    import threading

    h = 256 // width
    q, k, v, key_pad, static, g = _problem(37, 37, seed=width, b=3,
                                           dtype=dtype, hidden=h * width)
    scale = width ** -0.5
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, h, scale, True)
    want = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, h, scale)
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["grads"] = tatt.attention_bwd(q, k, v, key_pad, static, g,
                                              lse, h, scale)
            torch.cuda.synchronize()
        except RuntimeError as err:
            got["error"] = err

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    for name, a, b in zip(("dq", "dk", "dv"), got["grads"], want):
        assert torch.equal(a, b), name


# 2 heads of 128: the f32 K2 of csrc/attention_bwd_f32_d128.cuh (the
# mm.yaml model's hidden 256 at 2 heads)
H128 = 2


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case", ["encoder_eye_pad", "decoder_pad",
                                  "cross"])
def test_k2_f32_d128_matches_plain(case, rate):
    """The f32 K2 at head width 128 (2 heads, T = 200, B = 4) in the three
    mask cases of the model (the encoder's eye and key pad; the decoder's
    key pad with trial 2 fully padded; cross attention over 180 keys with a
    random mask), dropout 0 and 0.4: against the f32 plain version on the
    same lse and Philox bits (``_k2_gates``: atol 1e-5 + 1e-6 |plain|);
    the padded trial's dq exactly zero; a second launch bit-equal to the
    first."""
    _need_cuda()
    tk = 180 if case == "cross" else 200
    q, k, v, key_pad, static, g = _problem(200, tk, seed=7, b=4,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    if case == "encoder_eye_pad":
        static = torch.eye(200, dtype=torch.int32, device="cuda")
    elif case == "decoder_pad":
        static = torch.zeros_like(static)
        key_pad[2] = 0
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, 128 ** -0.5,
                                True, rate, 17)
    got = _k2_gates(q, k, v, key_pad, static, g, lse, rate, 17,
                    heads=H128)
    again = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H128,
                               128 ** -0.5, rate, 17)
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        assert torch.equal(a, b), name
    if case == "decoder_pad":
        assert got[0][2].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(1, 1), (17, 17), (47, 47), (48, 48),
                                   (49, 49), (63, 63), (64, 64), (65, 65),
                                   (200, 200), (241, 241), (256, 256),
                                   (257, 257), (520, 520), (200, 300),
                                   (300, 17), (65, 200)])
def test_k2_f32_d128_at_chunk_edges(tq, tk, rate):
    """The f32 K2 at head width 128 around its chunks and tiles: pass A's
    64 keys (one sweep up to 64, two past it; the attend bits held for up
    to 4 chunks, 256 keys, read a tile at a time past them), pass B's 48
    queries (held up to 5 chunks, 240 queries), 64-row tiles; self and
    cross, through the fused-QKV or KV column views, random masks: against
    the f32 plain version (``_k2_gates``)."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(tq, tk, seed=tq + tk,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, 128 ** -0.5,
                                True, rate, 43)
    _k2_gates(q, k, v, key_pad, static, g, lse, rate, 43, heads=H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k2_f32_d128_blocks_walking_several_heads(rate):
    """B = 256 at 2 heads of 128: the grid puts two heads in a block
    (``walk_heads``), so a block's second head loads its row tiles while
    the first finishes: against the f32 plain version (``_k2_gates``)."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(200, 200, seed=3, b=256,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, 128 ** -0.5,
                                True, rate, 29)
    _k2_gates(q, k, v, key_pad, static, g, lse, rate, 29, heads=H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k2_f32_d128_rank_slice_matches_the_whole_call(rate):
    """A rank's call under tensor and data parallelism at head width 128:
    the slice of trials [2, 4) and head 1 of a 4-trial, 2-head call, with
    draw offsets (2, 1), gives the whole call's dq, dk and dv of that slice
    bit for bit (the same sums in the same order, the same keep bits), and
    agrees with the plain version drawn at the same offsets."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(200, 200, seed=8, b=4,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    scale = 128 ** -0.5
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale, True,
                                rate, 51)
    whole = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H128, scale,
                               rate, 51)

    def part(x):
        return x[2:4, :, 128:].contiguous()

    args = (part(q), part(k), part(v), key_pad[2:4].contiguous(), static,
            part(g), lse[2:4, 1:].contiguous(), 1, scale, rate, 51)
    got = tatt.attention_bwd(*args, draw_offset=(2, 1))
    want = tatt.attention_bwd_reference(*args, draw_offset=(2, 1))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, whole, want):
        assert torch.equal(a, part(b)), name
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-6,
                                   msg=lambda m, n=name: f"{n}: {m}")


# 2 heads of 128 in bf16: the bf16 K2 of csrc/attention_bwd_bf16_d128.cuh,
# on the lse of the bf16 K1 at 128 (the mma.sync attn_fwd_tc_kernel, whose
# keep bits the K2's keep kernel replays)
BF16 = torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(1, 1), (63, 63), (64, 64), (65, 65),
                                   (200, 200), (208, 208), (209, 209),
                                   (520, 520), (1, 200), (200, 1), (63, 209),
                                   (209, 65), (520, 64), (65, 520)])
def test_k2_bf16_d128_at_chunk_edges(tq, tk, rate):
    """The bf16 K2 at head width 128 around its tiles and chunks: 64-row
    tiles, 208 columns at once (104 a warpgroup; one sweep up to 208, pass
    A's two sweeps past it), self and cross, through the fused-QKV or KV
    column views, random masks: against the bf16-dots plain version
    (``_k2_gates``: 1e-2 (1 + |plain|))."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(tq, tk, seed=tq + tk, dtype=BF16,
                                           hidden=H128 * 128)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, 128 ** -0.5,
                                True, rate, 43)
    _k2_gates(q, k, v, key_pad, static, g, lse, rate, 43, f32_gate=False,
              heads=H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k2_bf16_d128_blocks_walking_several_heads(rate):
    """B = 256 at 2 heads of 128: the grid puts two heads in a block
    (``walk_heads``), so a block's second head's copies are issued while
    the first finishes: against the bf16-dots plain version and the f32-dots
    one (``_k2_gates``)."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(200, 200, seed=3, b=256,
                                           dtype=BF16, hidden=H128 * 128)
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, 128 ** -0.5,
                                True, rate, 29)
    _k2_gates(q, k, v, key_pad, static, g, lse, rate, 29, heads=H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k2_bf16_d128_padded_trial_zero_and_bit_equal(rate):
    """A padded trial at head width 128 (every key masked, pad-only mask)
    gets exactly zero dq, dk and dv; two launches give the same bits (no
    atomics); the other trials are held to the plain version."""
    _need_cuda()
    q, k, v, key_pad, _, g = _problem(200, 200, seed=6, dtype=BF16,
                                      hidden=H128 * 128)
    key_pad[1] = 0
    static = torch.zeros(200, 200, dtype=torch.int32, device="cuda")
    scale = 128 ** -0.5
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale, True,
                                rate, 8)
    one = _k2_gates(q, k, v, key_pad, static, g, lse, rate, 8,
                    heads=H128)
    two = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H128, scale,
                             rate, 8)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
        assert a[1].abs().max().item() == 0.0
        assert a[0].abs().max().item() > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k2_bf16_d128_rank_slice_matches_the_whole_call(rate):
    """A rank's call under tensor and data parallelism at head width 128 in
    bf16: the slice of trials [2, 4) and head 1 of a 4-trial, 2-head call,
    with draw offsets (2, 1), gives the whole call's dq, dk and dv of that
    slice bit for bit, and agrees with the bf16-dots plain version drawn at
    the same offsets (1e-2 (1 + |plain|))."""
    _need_cuda()
    q, k, v, key_pad, static, g = _problem(200, 200, seed=8, b=4,
                                           dtype=BF16, hidden=H128 * 128)
    scale = 128 ** -0.5
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale, True,
                                rate, 51)
    whole = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H128, scale,
                               rate, 51)

    def part(x):
        return x[2:4, :, 128:].contiguous()

    args = (part(q), part(k), part(v), key_pad[2:4].contiguous(), static,
            part(g), lse[2:4, 1:].contiguous(), 1, scale, rate, 51)
    got = tatt.attention_bwd(*args, draw_offset=(2, 1))
    want = tatt.attention_bwd_reference(*args, dots_dtype=BF16,
                                        draw_offset=(2, 1))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, whole, want):
        assert torch.equal(a, part(b)), name
        _within(a, c, 1e-2, name)


@pytest.mark.cuda
@pytest.mark.parametrize("q0", [0, 77, 199])
def test_k2_bf16_d128_pass_b_keep_bits_read_back(q0):
    """Pass B's keep bits at head width 128 read back: q = k = 0 and every
    key attended make every probability 1/Tk (the bf16 K1's lse); v = 0 and
    g one-hot at query q0 make dv[b, k, h*128 + d] = ms(q0, k) / Tk, so dv
    > 0 exactly where Philox keeps (b, h, q0, k): the bits the bf16
    mma.sync K1 at 128 drew. rtol: one bf16 rounding of dv."""
    _need_cuda()
    tq = tk = 200
    rate, seed = 0.4, 987654321
    hidden = H128 * 128
    q = torch.zeros(B, tq, hidden, device="cuda", dtype=BF16)
    k = torch.zeros(B, tk, hidden, device="cuda", dtype=BF16)
    g = torch.zeros(B, tq, hidden, device="cuda")
    g[:, q0] = 1.0
    g = g.to(BF16)
    key_pad = torch.ones(B, tk, dtype=torch.int32, device="cuda")
    static = torch.zeros(tq, tk, dtype=torch.int32, device="cuda")
    _, lse = tatt.attention_fwd(q, k, k, key_pad, static, H128, 1.0,
                                with_lse=True, dropout_rate=rate, seed=seed)
    _, _, dv = tatt.attention_bwd(q, k, k, key_pad, static, g, lse, H128,
                                  1.0, rate, seed)
    dv = dv.float().reshape(B, tk, H128, 128).transpose(1, 2)
    keep = tatt.philox_keep(seed, B, H128, tq, tk, rate,
                            device="cuda")[:, :, q0]
    want = keep.float()[..., None] / (1 - rate) / tk
    torch.testing.assert_close(dv, want.expand_as(dv), atol=0, rtol=4e-3)


@pytest.mark.cuda
def test_k2_bf16_d128_rejects_misaligned_views():
    """TMA takes 16-byte aligned addresses and strides: a bf16 view at head
    width 128 whose data pointer or row stride is not 16-byte aligned
    raises ValueError and launches nothing."""
    _need_cuda()
    hidden = H128 * 128
    q, k, v, key_pad, static, g = _problem(17, 17, dtype=BF16, hidden=hidden)
    lse = torch.zeros(3, H128, 17, device="cuda")
    off = torch.zeros(3, 17, hidden + 8, device="cuda", dtype=BF16)
    off = off[..., 1:1 + hidden]                   # pointer one element off
    odd = torch.zeros(3, 17, hidden + 4, device="cuda", dtype=BF16)
    odd = odd[..., :hidden]                        # row stride 8 bytes off
    n0 = tatt.K2_LAUNCHES
    for bad in (off, odd):
        with pytest.raises(ValueError):
            tatt.attention_bwd(bad, k, v, key_pad, static, g, lse, H128, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_bwd(q, bad, v, key_pad, static, g, lse, H128, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_bwd(q, k, v, key_pad, static, bad, lse, H128, 1.0)
    assert tatt.K2_LAUNCHES == n0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k1_bf16_d128_lse_rows_sum_to_one(rate):
    """What the bf16 K2 at 128 relies on: with the scores it recomputes (s =
    bf16(q * scale) . k + bias, bf16 operands, f32 sums), every row that
    attends anything has sum_k exp(s - lse) = 1 against the lse of the bf16
    K1 at 128 (``attn_fwd_tc_kernel``; its l sums the undropped
    probabilities, so dropout leaves the lse as it is), within the bf16
    gate of ``chip_smoke.lse_row_sums``, 1e-3."""
    _need_cuda()
    q, k, _, key_pad, static, _ = _problem(200, 200, seed=10, b=4,
                                           dtype=BF16, hidden=H128 * 128)
    scale = 128 ** -0.5
    _, lse = tatt.attention_fwd(q, k, k, key_pad, static, H128, scale, True,
                                rate, 5)

    def heads(x):
        return x.unflatten(-1, (H128, 128)).transpose(1, 2).float()

    qs = (heads(q) * scale).bfloat16().float()
    s = (qs @ heads(k).transpose(-1, -2)
         + tatt._attend_bias(key_pad, static)[:, None])
    sums = torch.exp(s - lse[..., None]).sum(-1)            # (B, H, Tq)
    rows = (static.bool()[None] | key_pad.bool()[:, None]).any(-1)
    err = (sums - 1).abs()[rows[:, None].expand_as(sums)].max().item()
    assert err <= 1e-3, err


@pytest.mark.cuda
def test_k1_k2_bf16_d128_graph_replays_take_each_tables_keys():
    """The bf16 K1 (mma.sync, drawing its keep bits inside) and K2 (its keep
    kernel replaying them) at head width 128 with dropout, captured once in
    a CUDA graph keyed by a table entry, replayed with two tables: each
    replay's out and dq/dk/dv equal the eager launches under that table's
    key, bit for bit, and hold the bf16-dots plain version under that key
    (1e-2 (1 + |plain|)): the replayed K2 bits are the K1's own."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v, g = (torch.randn(B, T, H128 * 128, device="cuda",
                              generator=gen).to(BF16) for _ in range(4))
    key_pad, static = _operands("enc_eye_pad")
    table = _table(0, 0)
    seeds = (123_456_789_012, 987)
    scale = 128 ** -0.5

    def step():
        out, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale,
                                      True, 0.4, table[1:2])
        return (out, lse) + tatt.attention_bwd(
            q, k, v, key_pad, static, g, lse, H128, scale, 0.4, table[1:2])

    eager = []
    for s in seeds:
        table[1] = s
        eager.append([t.clone() for t in step()])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        outs = step()
    for s, want in zip(seeds, eager):
        table[1] = s
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want))
        plain = tatt.attention_bwd_reference(
            q, k, v, key_pad, static, g, want[1], H128, scale, 0.4, s,
            dots_dtype=BF16)
        for name, a, b in zip(("dq", "dk", "dv"), want[2:], plain):
            _within(a, b, 1e-2, name)
    assert not torch.equal(eager[0][0], eager[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("dtype", K2_DTYPES, ids=str)
@pytest.mark.parametrize("width", [8, 16, 24, 32, 64, 100, 128])
def test_k2_launches_the_kernel_of_its_route(width, dtype, rate):
    """What runs on the card: every width and dtype launches wgmma passes
    (``k2_route``): up to head width 64 ``attn_bwd_dq_tf_kernel`` /
    ``attn_bwd_dkdv_tf_kernel`` in f32 and ``attn_bwd_dq_wg_kernel`` /
    ``attn_bwd_dkdv_wg_kernel`` in bf16; at 128 (and 100, padded to it)
    ``attn_bwd_dq_tf128_kernel`` / ``attn_bwd_dkdv_tf128_kernel`` in f32 and
    ``attn_bwd_dq_wg128_kernel`` / ``attn_bwd_dkdv_wg128_kernel`` in bf16;
    with dropout ``attn_bwd_keep_kernel`` first; never the mma.sync
    ``attn_bwd_*_tc_kernel`` pair, which bf16 ran at 128 before. Read from
    the kernel names of a profile of three calls, opened by the port's
    lead-in (traced again if it lost K2's)."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from multi_modal_foundation_model_tpu_torch.utils.profiling import (
        profiler_lead_in)

    h = 256 // width
    gen = torch.Generator(device="cuda").manual_seed(width)
    q, k, v, g = torch.randn(4, 2, 70, h * width, device="cuda",
                             generator=gen).to(dtype)
    key_pad = torch.ones(2, 70, dtype=torch.int32, device="cuda")
    static = torch.zeros(70, 70, dtype=torch.int32, device="cuda")
    _, lse = tatt.attention_fwd(q, k, v, key_pad, static, h, width ** -0.5,
                                True, rate, 3)
    tatt.attention_bwd(q, k, v, key_pad, static, g, lse, h, width ** -0.5,
                       rate, 3)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_lead_in()
            for _ in range(3):
                tatt.attention_bwd(q, k, v, key_pad, static, g, lse, h,
                                   width ** -0.5, rate, 3)
            torch.cuda.synchronize()
        names = " ".join(e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        if "attn_bwd_dkdv_" in names:
            break
    assert tatt.k2_route(dtype, width) == "wgmma"
    tag = ("wg" if dtype == torch.bfloat16 else "tf") + (
        "" if tatt.kernel_head_dim(width) <= 64 else "128")
    for other in ("tf", "wg", "tf128", "wg128"):
        on = other == tag
        assert (f"attn_bwd_dq_{other}_kernel" in names) == on, names
        assert (f"attn_bwd_dkdv_{other}_kernel" in names) == on, names
    assert "_tc_kernel" not in names, names
    assert ("attn_bwd_keep_kernel" in names) == (rate > 0), names


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(207, 207), (208, 208), (209, 209),
                                   (257, 257), (520, 520), (200, 300),
                                   (300, 17)])
def test_k1_bf16_wgmma_at_chunk_edges(tq, tk, rate):
    """The bf16 wgmma K1 around its 208-key chunk (one chunk up to 208, the
    online rescale across two or three past it) and its 64-query tiles,
    self and cross, through the fused-QKV or KV column views, random
    masks, with lse: against the plain versions (``_k1_gates``)."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(tq, tk, seed=tq + tk)
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H,
                                  1.0 / math.sqrt(D), with_lse=True,
                                  dropout_rate=rate, seed=41)
    torch.cuda.synchronize()
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 41)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(200, 200), (257, 257), (300, 17)])
def test_k1_bf16_draw_offset_matches_plain_and_bit_equal(tq, tk, rate):
    """The bf16 K1 of a rank's slice, draw offsets (b0, h0) = (5, 3):
    against the plain version drawn at the same offsets (``_k1_gates``'s
    bf16 gates), and a second launch bit-equal to the first (fixed-order
    sums, no atomics), in one chunk and across chunks."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(tq, tk, seed=12)
    scale, off = 1.0 / math.sqrt(D), (5, 3)
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, scale, True,
                                  rate, 31, draw_offset=off)
    again, lse2 = tatt.attention_fwd(q, k, v, key_pad, static, H, scale,
                                     True, rate, 31, draw_offset=off)
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    want, want_lse = tatt.attention_reference(
        q, k, v, key_pad, static, H, scale, True, rate, 31,
        dots_dtype=torch.bfloat16, draw_offset=off)
    _within(got, want, 1e-2, "out")
    _within(lse, want_lse, 1e-5, "lse")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
@pytest.mark.parametrize("width", [8, 16, 24, 32, 64, 100, 128])
def test_k1_launches_the_kernel_of_its_route(width, dtype, rate):
    """What runs on the card: bf16 up to head width 64 launches
    ``attn_fwd_wg_kernel``, f32 at 128 (and 100, padded to it)
    ``attn_fwd_tf128_kernel``, each with dropout ``attn_fwd_keep_kernel``
    first, never the mma.sync ``attn_fwd_tc_kernel``; f32 up to 64 and
    bf16 at 128 the mma.sync kernel alone (``k1_route``). Read from the
    kernel names of a profile of three calls, opened by the port's lead-in
    (a trace loses its first records on the card; traced again if it lost
    K1's)."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    from multi_modal_foundation_model_tpu_torch.utils.profiling import (
        profiler_lead_in)

    h = 256 // width
    gen = torch.Generator(device="cuda").manual_seed(width)
    q, k, v = torch.randn(3, 2, 70, h * width, device="cuda",
                          generator=gen).to(dtype)
    key_pad = torch.ones(2, 70, dtype=torch.int32, device="cuda")
    static = torch.zeros(70, 70, dtype=torch.int32, device="cuda")
    tatt.attention_fwd(q, k, v, key_pad, static, h, width ** -0.5, True,
                       rate, 3)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiler_lead_in()
            for _ in range(3):
                tatt.attention_fwd(q, k, v, key_pad, static, h,
                                   width ** -0.5, True, rate, 3)
            torch.cuda.synchronize()
        names = " ".join(e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        if "attn_fwd_" in names:
            break
    wgmma = tatt.k1_route(dtype, width) == "wgmma"
    tag = "tf128" if dtype == torch.float32 else "wg"
    for other in ("wg", "tf128"):
        on = wgmma and other == tag
        assert (f"attn_fwd_{other}_kernel" in names) == on, names
    assert ("attn_fwd_tc_kernel" in names) == (not wgmma), names
    assert ("attn_fwd_keep_kernel" in names) == (wgmma and rate > 0), names


# the f32 K1 of csrc/attention_fwd_f32_d128.cuh at 2 heads of 128 (H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("case", ["encoder_eye_pad", "decoder_pad",
                                  "cross"])
def test_k1_f32_d128_matches_plain(case, rate):
    """The f32 K1 at head width 128 (2 heads, T = 200, B = 4) in the three
    mask cases of the model (the encoder's eye and key pad; the decoder's
    key pad with trial 2 fully padded; cross attention over 180 keys with a
    random mask), dropout 0 and 0.4, with lse: against the f32 plain
    version on the same Philox bits (``_k1_gates``: atol 1e-5); a second
    launch bit-equal to the first."""
    _need_cuda()
    tk = 180 if case == "cross" else 200
    q, k, v, key_pad, static, _ = _problem(200, tk, seed=7, b=4,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    if case == "encoder_eye_pad":
        static = torch.eye(200, dtype=torch.int32, device="cuda")
    elif case == "decoder_pad":
        static = torch.zeros_like(static)
        key_pad[2] = 0
    scale = 128 ** -0.5
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale,
                                  True, rate, 17)
    again, lse2 = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale,
                                     True, rate, 17)
    assert torch.equal(got, again) and torch.equal(lse, lse2)
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 17, heads=H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("tq,tk", [(1, 1), (17, 17), (63, 63), (64, 64),
                                   (65, 65), (127, 127), (128, 128),
                                   (129, 129), (200, 200), (209, 209),
                                   (256, 256), (257, 257), (520, 520),
                                   (200, 300), (300, 17), (65, 200)])
def test_k1_f32_d128_at_chunk_edges(tq, tk, rate):
    """The f32 K1 at head width 128 around its chunks and tiles: 64 keys a
    warpgroup, 128 a chunk (one sweep up to 128, the online rescale past
    it; the attend bits held for up to 2 chunks, 256 keys, read a chunk at
    a time past them), 64-query tiles; self and cross, through the
    fused-QKV or KV column views, random masks, with lse: against the f32
    plain version (``_k1_gates``)."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(tq, tk, seed=tq + tk,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    n0 = tatt.K1_LAUNCHES
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128,
                                  128 ** -0.5, True, rate, 43)
    torch.cuda.synchronize()
    assert tatt.K1_LAUNCHES == n0 + 1
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 43, heads=H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k1_f32_d128_blocks_walking_several_heads(rate):
    """B = 256 at 2 heads of 128: the grid puts two heads in a block
    (``walk_heads``), so a block loads its second head's q with that
    head's first k chunk: against the f32 plain version (``_k1_gates``)."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(200, 200, seed=3, b=256,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    got, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128,
                                  128 ** -0.5, True, rate, 29)
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 29, heads=H128)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k1_f32_d128_fully_masked_row_and_bit_equal(rate):
    """A padded trial at head width 128 (every key masked, pad-only mask,
    200 keys: two chunks): its rows are the mean of V (of the kept V / (1 -
    rate) with dropout) within 1e-5 and their lse is -1e6 + log(Tk); two
    launches give the same bits."""
    _need_cuda()
    q, k, v, key_pad, _, _ = _problem(200, 200, seed=6, dtype=torch.float32,
                                      hidden=H128 * 128)
    key_pad[1] = 0
    static = torch.zeros(200, 200, dtype=torch.int32, device="cuda")
    scale = 128 ** -0.5
    one = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale, True,
                             rate, 8)
    two = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale, True,
                             rate, 8)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    got, lse = one
    _k1_gates(q, k, v, key_pad, static, got, lse, rate, 8, heads=H128)
    floor = torch.tensor(-1e6) + torch.log(torch.tensor(200.0))
    torch.testing.assert_close(lse[1].cpu(), floor.expand(H128, 200),
                               atol=0.07, rtol=0)
    vh = v[1].reshape(200, H128, 128).transpose(0, 1)       # (H, Tk, D)
    if rate > 0.0:
        keep = tatt.philox_keep(8, 2, H128, 200, 200, rate,
                                device="cuda")[1]
        mean = (keep.float() / (1.0 - rate)) @ vh / 200     # (H, Tq, D)
    else:
        mean = vh.mean(1, keepdim=True).expand(H128, 200, 128)
    row = got[1].reshape(200, H128, 128).transpose(0, 1)
    torch.testing.assert_close(row, mean, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_k1_f32_d128_rank_slice_matches_the_whole_call(rate):
    """A rank's call under tensor and data parallelism at head width 128:
    the slice of trials [2, 4) and head 1 of a 4-trial, 2-head call, with
    draw offsets (2, 1), gives the whole call's out and lse of that slice
    bit for bit (the same sums in the same order, the same keep bits), and
    agrees with the plain version drawn at the same offsets."""
    _need_cuda()
    q, k, v, key_pad, static, _ = _problem(200, 200, seed=8, b=4,
                                           dtype=torch.float32,
                                           hidden=H128 * 128)
    scale = 128 ** -0.5
    whole, whole_lse = tatt.attention_fwd(q, k, v, key_pad, static, H128,
                                          scale, True, rate, 51)

    def part(x):
        return x[2:4, :, 128:].contiguous()

    args = (part(q), part(k), part(v), key_pad[2:4].contiguous(), static)
    got, lse = tatt.attention_fwd(*args, 1, scale, True, rate, 51,
                                  draw_offset=(2, 1))
    assert torch.equal(got, part(whole))
    assert torch.equal(lse, whole_lse[2:4, 1:])
    _k1_gates(*args, got, lse, rate, 51, heads=1, draw_offset=(2, 1))


@pytest.mark.cuda
def test_k1_f32_d128_philox_bits_match_philox_keep():
    """Read the f32 K1's keep mask back at head width 128: q = 0 and all
    keys attended make every probability 1 (before 1/l = 1/Tk); V's rows
    are one-hot per head (Tk = D = 128, one chunk), so out[b, q, h*128 +
    k] > 0 exactly where Philox keeps (b, h, q, k)."""
    _need_cuda()
    tk, rate, seed = 128, 0.4, 123456789
    q = torch.zeros(B, T, H128 * 128, device="cuda")
    v = torch.eye(128, device="cuda").repeat(1, H128).expand(
        B, tk, H128 * 128).contiguous()
    k = torch.zeros(B, tk, H128 * 128, device="cuda")
    key_pad = torch.ones(B, tk, dtype=torch.int32, device="cuda")
    static = torch.zeros(T, tk, dtype=torch.int32, device="cuda")
    out, _ = tatt.attention_fwd(q, k, v, key_pad, static, H128, 1.0,
                                dropout_rate=rate, seed=seed)
    got = out.reshape(B, T, H128, 128).transpose(1, 2) > 0
    want = tatt.philox_keep(seed, B, H128, T, tk, rate, device="cuda")
    assert torch.equal(got, want)
    assert 0.5 < want.float().mean().item() < 0.7


@pytest.mark.cuda
def test_k1_f32_d128_rejects_misaligned_views():
    """TMA copies need 16-byte aligned data pointers and strides: an f32
    view at head width 128 whose data pointer or row stride is not 16-byte
    aligned raises ValueError before any launch."""
    _need_cuda()
    hidden = H128 * 128
    q, k, v, key_pad, static, _ = _problem(17, 17, dtype=torch.float32,
                                           hidden=hidden)
    wide = torch.zeros(3, 17, hidden + 4, device="cuda")
    off = wide[..., 1:1 + hidden]                  # pointer one element off
    odd = torch.zeros(3, 17, hidden + 2, device="cuda")[..., :hidden]
    n0 = tatt.K1_LAUNCHES
    for bad in (off, odd):
        with pytest.raises(ValueError):
            tatt.attention_fwd(bad, k, v, key_pad, static, H128, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_fwd(q, bad, v, key_pad, static, H128, 1.0)
        with pytest.raises(ValueError):
            tatt.attention_fwd(q, k, bad, key_pad, static, H128, 1.0)
    assert tatt.K1_LAUNCHES == n0


@pytest.mark.cuda
def test_k1_k2_f32_d128_graph_replays_take_each_tables_keys():
    """The f32 K1 and K2 at head width 128 with dropout, captured once in a
    CUDA graph keyed by a table entry, replayed with two tables: each
    replay's out and dq/dk/dv equal the eager launches under that table's
    key, bit for bit (the keep kernels read the key on the device)."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v, g = (torch.randn(B, T, H128 * 128, device="cuda",
                              generator=gen) for _ in range(4))
    key_pad, static = _operands("enc_eye_pad")
    table = _table(0, 0)
    seeds = (123_456_789_012, 987)
    scale = 128 ** -0.5

    def step():
        out, lse = tatt.attention_fwd(q, k, v, key_pad, static, H128, scale,
                                      True, 0.4, table[1:2])
        return (out,) + tatt.attention_bwd(q, k, v, key_pad, static, g,
                                           lse, H128, scale, 0.4, table[1:2])

    eager = []
    for s in seeds:
        table[1] = s
        eager.append([t.clone() for t in step()])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        outs = step()
    for s, want in zip(seeds, eager):
        table[1] = s
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert not torch.equal(eager[0][0], eager[1][0])


LN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _ln_operands(rows, width, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, width, device="cuda", generator=g) * 2.0 + 0.3)
    w = torch.randn(width, device="cuda", generator=g) * 0.2 + 1.0
    b = torch.randn(width, device="cuda", generator=g) * 0.1
    dy = torch.randn(rows, width, device="cuda", generator=g)
    return x.to(dtype), w, b, dy.to(dtype)


def _normwise(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,width", [(37 * 4, 256), (50 * 4, 64),
                                        (1001, 256), (129, 96),
                                        (3, 1024), (1, 256), (3200, 256),
                                        (51200, 256), (51199, 256),
                                        (3200, 48), (129, 100), (65, 3),
                                        (33, 1001), (3200, 2048),
                                        (129, 1025), (65, 4096)])
def test_k3_k4_match_plain(rows, width, dtype):
    """K3 and K4 against ``layer_norm`` / ``layer_norm_bwd_reference``:
    odd row counts (ragged warps and blocks), H = 64, 96, 256, 1024; one
    row; the training step's 3,200 (B=16) and 51,200 (B=256) rows, and
    51,199, whose last K4 tile is short; widths that are not a multiple of
    32 (48, 100, 3, 1001: vector widths 2, 4, 1, 1) and above 1024 (a row
    a block: 2048, 1025, 4096)."""
    _need_cuda()
    dt, tol = getattr(torch, dtype), LN_TOL[dtype]
    x, w, b, dy = _ln_operands(rows, width, dt)
    n3, n4 = tln.K3_LAUNCHES, tln.K4_LAUNCHES
    y = tln.layernorm_fwd(x, w, b, 1e-5, dt)
    dx, dw, db = tln.layernorm_bwd(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    assert (tln.K3_LAUNCHES - n3, tln.K4_LAUNCHES - n4) == (1, 1)
    assert y.dtype == dt and dx.dtype == dt
    assert dw.dtype == db.dtype == torch.float32
    torch.testing.assert_close(y.float(), tln.layer_norm(x, w, b, 1e-5,
                                                         dt).float(),
                               atol=tol, rtol=tol)
    want = tln.layer_norm_bwd_reference(x, w, dy, 1e-5)
    torch.testing.assert_close(dx.float(), want[0].float(), atol=tol,
                               rtol=tol)
    assert _normwise(dw, want[1]) <= 1e-5
    assert _normwise(db, want[2]) <= 1e-5
    # dweight / dbias: a fixed summation order, the same bits every run
    dx2, dw2, db2 = tln.layernorm_bwd(x, w, dy, 1e-5)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(dx, dx2)


def _k4_outputs_match(got, want, x, w, dy, tol):
    """``got`` = (dx, dweight, dbias) against the plain version, and bit
    for bit against ``want`` where given."""
    ref = tln.layer_norm_bwd_reference(x, w, dy, 1e-5)
    torch.testing.assert_close(got[0].float(), ref[0].float(), atol=tol,
                               rtol=tol)
    assert _normwise(got[1], ref[1]) <= 1e-5
    assert _normwise(got[2], ref[2]) <= 1e-5
    if want is not None:
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_back_to_back_row_counts(dtype):
    """K4 launched back to back at 51,200, 3, 3,200, 51,200, 3 and 3,200
    rows with no synchronisation between: every result matches the plain
    version and, at a row count seen before, the first launch's bits, so
    neither the scratch nor the plan carries anything from one launch to
    the next."""
    _need_cuda()
    dt, tol = getattr(torch, dtype), LN_TOL[dtype]
    operands = {rows: _ln_operands(rows, 256, dt, seed=rows)
                for rows in (51200, 3, 3200)}
    got = []
    for rows in (51200, 3, 3200, 51200, 3, 3200):
        x, w, _, dy = operands[rows]
        got.append((rows, tln.layernorm_bwd(x, w, dy, 1e-5)))
    torch.cuda.synchronize()
    first = {}
    for rows, out in got:
        x, w, _, dy = operands[rows]
        _k4_outputs_match(out, first.get(rows), x, w, dy, tol)
        first.setdefault(rows, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [3200, 51200])
def test_k4_cuda_graph_replay_matches_eager(rows, dtype):
    """K4 captured in a CUDA graph (no host synchronisation, no allocation
    that depends on the data) and replayed three times, its outputs zeroed
    before each replay: dx, dweight and dbias equal the eager launch's bit
    for bit."""
    _need_cuda()
    dt = getattr(torch, dtype)
    x, w, _, dy = _ln_operands(rows, 256, dt, seed=rows)
    eager = tln.layernorm_bwd(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n4 = tln.K4_LAUNCHES
    with torch.cuda.graph(graph):
        out = tln.layernorm_bwd(x, w, dy, 1e-5)
    assert tln.K4_LAUNCHES - n4 == 1
    for _ in range(3):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [48, 64, 256, 1024, 2048])
def test_k4_plan_is_one_wave_on_the_card(width, dtype):
    """The card holds at least one pass-1 block an SM, so the plan's grid
    (at most SMs x blocks an SM) runs in one wave; the kernel refuses a
    plan whose tiles leave rows out or hold none, and a layout that is not
    the planner's kind (a vector width that does not divide H)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    layout = tln.ln_plan(width, dt)
    lib = tln._lib(layout.variant)
    n_sm, per_sm = tln._k4_card(lib, torch.device("cuda", 0), width, dt)
    assert n_sm == torch.cuda.get_device_properties(0).multi_processor_count
    assert per_sm >= 1
    at_once = 8 if layout.variant == "warp" else 1
    for rows in (3200, 51200):
        plan = tln._k4_plan(rows, n_sm, per_sm, at_once)
        assert min(n_sm, rows) <= plan.grid <= n_sm * per_sm
    x, w, _, dy = _ln_operands(100, width, dt)
    dx = torch.empty_like(x)
    buf = torch.empty(2 * width * 40, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for grid, tile, vec in ((9, 10, layout.vec), (11, 10, layout.vec),
                            (10, 0, layout.vec), (10, 10, 3)):
        rc = lib.mmfm_layernorm_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            buf.data_ptr(), buf[2 * width:].data_ptr(), grid, tile, 100,
            width, layout.epl, vec, 1e-5, tln._DTYPE_CODE[dt], stream)
        assert rc != 0


@pytest.mark.cuda
def test_k3_k4_reject_what_they_do_not_take():
    """Widths above 4096, an output dtype other than x's, g in another
    dtype, and CPU tensors raise."""
    _need_cuda()
    for width in (4097, 8192):
        x, w, b, dy = _ln_operands(8, width, torch.float32)
        with pytest.raises(ValueError, match="4096"):
            tln.layernorm_fwd(x, w, b)
        with pytest.raises(ValueError, match="4096"):
            tln.layernorm_bwd(x, w, dy)
    x, w, b, dy = _ln_operands(8, 64, torch.bfloat16)
    with pytest.raises(TypeError):               # bf16 -> f32 output
        tln.layernorm_fwd(x, w, b)
    with pytest.raises(TypeError):
        tln.layernorm_bwd(x, w, dy.float())
    with pytest.raises(TypeError):
        tln.layernorm_fwd(x.half(), w, b, dtype=torch.float16)
    with pytest.raises(ValueError):
        tln.layernorm_fwd(x.cpu(), w.cpu(), b.cpu(), dtype=torch.bfloat16)
    # under "full", a CUDA tensor of an unsupported width raises in the
    # module: no plain fallback
    ln = tln.LayerNorm(4097).cuda()
    old = tln.PALLAS_LAYERNORM
    tln.PALLAS_LAYERNORM = "full"
    try:
        with pytest.raises(ValueError):
            ln(torch.randn(4, 4097, device="cuda"))
    finally:
        tln.PALLAS_LAYERNORM = old


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bwd", "full"])
def test_layernorm_functions_kernel_vs_autograd(mode):
    """The "bwd"/"full" Functions on the card against autograd of the plain
    form ("off"), bf16 in and out with f32 parameters."""
    _need_cuda()
    x, w, b, dy = _ln_operands(300, 256, torch.bfloat16, seed=4)
    grads = []
    old = tln.PALLAS_LAYERNORM
    for m in (mode, "off"):
        xx, ww, bb = (t.detach().clone().requires_grad_(True)
                      for t in (x, w, b))
        n4 = tln.K4_LAUNCHES
        tln.PALLAS_LAYERNORM = m
        try:
            y = tln.layernorm(xx, ww, bb, 1e-5, torch.bfloat16)
            grads.append((y,) + torch.autograd.grad(y, (xx, ww, bb), dy))
        finally:
            tln.PALLAS_LAYERNORM = old
        assert tln.K4_LAUNCHES - n4 == (1 if m != "off" else 0)
    for name, a, c in zip(("y", "dx", "dw", "db"), *grads):
        if name in ("dw", "db"):
            assert _normwise(a, c) <= 1e-5, name
        else:
            _bf16_close(a, c, name)


@pytest.mark.cuda
def test_model_full_layernorm_launches_k3_32_per_forward():
    """The bf16 5+5-layer model under ``PALLAS_LAYERNORM="full"``: 30
    in-layer norms + encoder_norm + decoder_norm = 32 K3 launches per
    forward, 15 K1, and the same preds as the plain LayerNorm ("off")."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tmm.MultiModalConfig(n_channels={"ap": 30, "behavior": 2},
                               max_F=T, hidden_size=128, n_heads=4,
                               inter_size=256, compute_dtype="bfloat16")
    model = tmm.MultiModal(cfg)
    rng = np.random.default_rng(5)
    attn = torch.ones(B, T, dtype=torch.int64, device="cuda")
    ts = torch.arange(T, device="cuda").expand(B, T)

    def mi(c):
        x = torch.from_numpy(rng.poisson(1.0, (B, T, c)).astype(np.float32))
        ev = torch.from_numpy((rng.random((B, T, c)) > 0.5).astype(np.int32))
        return tmm.ModalityInput(x.cuda(), x.cuda(), attn, ts, ev.cuda())

    inputs = {"ap": mi(30), "behavior": mi(2)}
    old = tln.PALLAS_LAYERNORM
    try:
        preds = {}
        for mode in ("full", "off"):
            tln.PALLAS_LAYERNORM = mode
            n1, n3 = tatt.K1_LAUNCHES, tln.K3_LAUNCHES
            with torch.inference_mode():
                preds[mode] = model(inputs).mod_preds["ap"]
            torch.cuda.synchronize()
            assert tatt.K1_LAUNCHES - n1 == 15
            assert tln.K3_LAUNCHES - n3 == (32 if mode == "full" else 0)
    finally:
        tln.PALLAS_LAYERNORM = old
    assert preds["full"].dtype == torch.float32
    rel = ((preds["full"] - preds["off"]).norm()
           / preds["off"].norm()).item()
    assert rel <= 2e-2


# ---------------------------------------------------------------------------
# keys from the device seed table, the Philox draw kernel, captured steps
# ---------------------------------------------------------------------------

def _table(*seeds):
    """A seed table on the card: int64 entries, read by the kernels."""
    return torch.tensor(seeds, dtype=torch.int64, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
def test_k1_k2_keyed_from_the_device_seed_table(dtype):
    """K1 and K2 take their Philox key from a seed-table entry (a pointer
    into device memory): K1's keep mask read back (q = 0, one-hot V) and
    K2's pass B bits read back (g one-hot at query 5, v = 0) are
    ``philox_keep``'s under the entry's value, a 63-bit table seed whose
    low 32 bits are the key. rtol as the read-back tests above."""
    _need_cuda()
    tk, rate = D, 0.4
    table = _table(2 ** 40 + 11, 6_000_000_000_123, 77)
    entry = table[1:2]
    q = torch.zeros(B, T, H * D, device="cuda", dtype=dtype)
    v = torch.eye(D, device="cuda").repeat(1, H).expand(B, tk, H * D)
    v = v.contiguous().to(dtype)
    k = torch.zeros(B, tk, H * D, device="cuda", dtype=dtype)
    key_pad = torch.ones(B, tk, dtype=torch.int32, device="cuda")
    static = torch.zeros(T, tk, dtype=torch.int32, device="cuda")
    out, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, 1.0,
                                  with_lse=True, dropout_rate=rate,
                                  seed=entry)
    got = out.float().reshape(B, T, H, D).transpose(1, 2) > 0
    want = tatt.philox_keep(entry, B, H, T, tk, rate, device="cuda")
    assert torch.equal(got, want)
    assert torch.equal(want, tatt.philox_keep(6_000_000_000_123, B, H, T,
                                              tk, rate, device="cuda"))
    g = torch.zeros(B, T, H * D, device="cuda")
    g[:, 5] = 1.0
    g = g.to(dtype)
    _, _, dv = tatt.attention_bwd(q, k, torch.zeros_like(v), key_pad,
                                  static, g, lse, H, 1.0, rate, entry)
    dv = dv.float().reshape(B, tk, H, D).transpose(1, 2)
    keep = want[:, :, 5].float()[..., None] / (1 - rate) / tk
    rtol = 4e-3 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dv, keep.expand_as(dv), atol=0, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K1_DTYPES, ids=str)
def test_k1_k2_graph_replays_take_each_tables_keys(dtype):
    """K1 + K2 with dropout captured once in a CUDA graph keyed by a table
    entry, replayed with two tables: each replay's out and dq/dk/dv equal
    the eager launches under that table's key, bit for bit."""
    _need_cuda()
    gen = torch.Generator("cuda").manual_seed(4)
    q, k, v, g = (torch.randn(B, T, H * D, device="cuda", generator=gen)
                  .to(dtype) for _ in range(4))
    key_pad, static = _operands("enc_eye_pad")
    table = _table(0, 0)
    seeds = (123_456_789_012, 987)

    def step():
        out, lse = tatt.attention_fwd(q, k, v, key_pad, static, H, 0.17,
                                      True, 0.4, table[1:2])
        return (out,) + tatt.attention_bwd(q, k, v, key_pad, static, g,
                                           lse, H, 0.17, 0.4, table[1:2])

    eager = []
    for s in seeds:
        table[1] = s
        eager.append([t.clone() for t in step()])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        outs = step()
    for s, want in zip(seeds, eager):
        table[1] = s
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert not torch.equal(eager[0][0], eager[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 15, 16, 17, 4097, 65539, 819203])
def test_philox_draw_kernel_matches_plain(n):
    """``csrc/random.cu``'s byte and uniform draws against their plain
    versions, bit for bit, at sizes that are and are not multiples of 4
    and 16, two streams, a 63-bit key from a table entry."""
    _need_cuda()
    from multi_modal_foundation_model_tpu_torch.ops import random as trand

    table = _table(5, 2 ** 62 + 12345)
    for stream in (0, 2):
        key = table[1:2]
        n0 = trand.PHILOX_LAUNCHES
        got_u8 = trand.u8_bits(key, (n,), stream)
        got_u = trand.uniform(key, (n,), stream)
        assert trand.PHILOX_LAUNCHES - n0 == 2
        assert torch.equal(got_u8, trand.u8_bits_reference(key, (n,),
                                                           stream))
        assert torch.equal(got_u, trand.uniform_reference(key, (n,),
                                                          stream))
        assert got_u.min() >= 0 and got_u.max() < 1


def _toy_trainer(tmp, device, **tcfg_over):
    from multi_modal_foundation_model_tpu_torch.data import loader, session
    from multi_modal_foundation_model_tpu_torch.train import (
        MultiModalTrainer, OptimizerConfig, TrainerConfig)

    geom = dict(n_channels={"ap": 24, "behavior": 2}, max_F=20,
                hidden_size=64, n_heads=2, n_enc_layers=2, n_dec_layers=2,
                inter_size=128)
    cfg = tmm.MultiModalConfig(**geom, dropout=0.4, embed_dropout=0.2,
                               remat_layers=True)
    model = tmm.MultiModal(cfg, device=device,
                           generator=torch.Generator().manual_seed(0))
    sess = session.synthetic_session(seed=0, n_trials=56, n_neurons=24,
                                     n_timesteps=20)
    kw = dict(batch_size=16, max_time_length=20, max_space_length=24)
    tcfg = TrainerConfig(num_epochs=2, log_dir=str(tmp), seed=0,
                         mask_type="input",
                         mask_mode=("temporal", "random", "inter-region"),
                         **tcfg_over)
    return MultiModalTrainer(model, loader.make_loader(sess, **kw), None,
                             OptimizerConfig(lr=1e-3), tcfg)


@pytest.mark.cuda
def test_captured_toy_step_equals_the_eager_step(tmp_path):
    """A toy model (dropout 0.4, embedding dropout 0.2, remat, MtM schemes)
    trained 2 epochs on the card: the resident path, whose steps after each
    variant's first are CUDA-graph replays (K = 2, with a remainder step),
    against the eager host-batch path on the same steps. Not bit for bit:
    cuBLAS picks another f32 GEMM kernel for the tokenizer's first Linear
    in one of the two runs (``scripts/torch_graph_vs_eager.py --trainer``:
    identical inputs, outputs a few ulps apart; the port's kernels give
    the same bits captured and eager), so they are held at the f32 step
    gates: per-step loss rtol 1e-5, parameters atol 2e-5 (the JAX
    lockstep's gate; key biases, whose exact gradient is 0, left out)."""
    _need_cuda()
    eager = _toy_trainer(tmp_path / "e", "cuda")
    graph = _toy_trainer(tmp_path / "g", "cuda", device_resident_data=True,
                         steps_per_dispatch=2)
    le = eager.train_epoch(0)["step_losses"] + \
        eager.train_epoch(1)["step_losses"]
    lg = graph.train_epoch(0)["step_losses"] + \
        graph.train_epoch(1)["step_losses"]
    assert graph.graphs.replays > 0 and len(graph.graphs.graphs) >= 2
    np.testing.assert_allclose(lg, le, rtol=1e-5, atol=0)
    for (n, a), b in zip(eager.model.state_dict().items(),
                         graph.model.state_dict().values()):
        if not n.endswith("key.bias"):
            torch.testing.assert_close(b, a, atol=2e-5, rtol=0, msg=n)


@pytest.mark.cuda
def test_prefetched_toy_epoch_equals_the_plain_epoch(tmp_path):
    """``prefetch_depth=2`` on the card: batches pinned and copied on a side
    stream, the consumer waiting on an event; the eager host-batch path
    trains 2 epochs on the same batches as without it (held at the f32
    gates of the captured-step test above)."""
    _need_cuda()
    plain = _toy_trainer(tmp_path / "p", "cuda")
    pre = _toy_trainer(tmp_path / "f", "cuda", prefetch_depth=2)
    lp = plain.train_epoch(0)["step_losses"] + \
        plain.train_epoch(1)["step_losses"]
    lf = pre.train_epoch(0)["step_losses"] + \
        pre.train_epoch(1)["step_losses"]
    np.testing.assert_allclose(lf, lp, rtol=1e-5, atol=0)
    for (n, a), b in zip(plain.model.state_dict().items(),
                         pre.model.state_dict().values()):
        if not n.endswith("key.bias"):
            torch.testing.assert_close(b, a, atol=2e-5, rtol=0, msg=n)


# ---------------------------------------------------------------------------
# the session-rows kernel (the fixed-order backward of per-sample gathers)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,shape", [(16, (1024, 512)), (1, (7,)),
                                     (33, (3, 5)), (256, (256,)),
                                     (40, (13, 1))])
def test_session_rows_grad_matches_plain(B, shape, dtype):
    """Bit for bit against the plain version (both add each session's
    rows in sample order from 0), on the 16-byte path and the element
    path (odd widths), with sessions absent from the batch exactly 0, and
    bit-equal from one launch to the next."""
    _need_cuda()
    from multi_modal_foundation_model_tpu_torch.ops import session_rows as sr

    gen = torch.Generator(device="cuda").manual_seed(B)
    S = 6
    ids = torch.randint(0, S - 1, (B,), device="cuda", generator=gen)
    g = torch.randn((B,) + shape, device="cuda", generator=gen).to(dtype)
    got = sr.session_rows_grad(g, ids, S)
    assert got.dtype == torch.float32 and got.shape == (S,) + shape
    assert torch.equal(got, sr.session_rows_grad_reference(g, ids, S))
    assert torch.equal(got, sr.session_rows_grad(g, ids, S))
    assert (got[S - 1] == 0).all()


@pytest.mark.cuda
def test_session_rows_grad_misaligned_view_and_graph_replay():
    """A view that starts off a 16-byte boundary takes the element path;
    a CUDA-graph replay with new ids and gradients sums what an eager
    launch sums."""
    _need_cuda()
    from multi_modal_foundation_model_tpu_torch.ops import session_rows as sr

    S, B = 4, 9
    base = torch.randn(B * 64 + 1, device="cuda")
    g = base[1:].reshape(B, 64)
    ids = torch.tensor([3, 0, 3, 1, 3, 0, 2, 3, 1], device="cuda")
    assert torch.equal(sr.session_rows_grad(g, ids, S),
                       sr.session_rows_grad_reference(g, ids, S))
    g_buf = torch.randn(B, 128, device="cuda")
    ids_buf = ids.clone()
    sr.session_rows_grad(g_buf, ids_buf, S)         # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sr.session_rows_grad(g_buf, ids_buf, S)
    g_buf.copy_(torch.randn(B, 128, device="cuda"))
    ids_buf.copy_(torch.tensor([1, 1, 1, 0, 2, 2, 0, 1, 3], device="cuda"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, sr.session_rows_grad_reference(g_buf, ids_buf, S))
