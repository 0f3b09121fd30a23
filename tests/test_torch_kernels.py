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
    with pytest.raises(ValueError):              # head width 24
        tatt.attention_fwd(q[..., :96], q[..., :96], q[..., :96], key_pad,
                           static, H, 1.0)
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
                   f32_gate=True):
    """The bf16 K2 against the bf16-dots plain version (1e-2) and, with
    ``f32_gate``, the f32-dots one (2e-2); returns the kernel's (dq, dk,
    dv)."""
    scale = 1.0 / math.sqrt(D)
    n0 = tatt.K2_LAUNCHES
    got = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                             rate, seed)
    torch.cuda.synchronize()
    assert tatt.K2_LAUNCHES == n0 + 1
    args = (q, k, v, key_pad, static, g, lse, H, scale, rate, seed)
    want = tatt.attention_bwd_reference(*args, dots_dtype=torch.bfloat16)
    want_f32 = tatt.attention_bwd_reference(*args)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, want_f32):
        assert a.dtype == torch.bfloat16 and a.is_contiguous(), name
        assert torch.isfinite(a).all(), name
        _within(a, b, 1e-2, name)
        if f32_gate:
            _within(a, c, 2e-2, name)
    return got


def _k2_gates(q, k, v, key_pad, static, g, lse, rate, seed, f32_gate=True):
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
    lse; the bound is ~1e-4)."""
    if q.dtype == torch.bfloat16:
        return _k2_bf16_gates(q, k, v, key_pad, static, g, lse, rate, seed,
                              f32_gate)
    scale = 1.0 / math.sqrt(D)
    n0 = tatt.K2_LAUNCHES
    got = tatt.attention_bwd(q, k, v, key_pad, static, g, lse, H, scale,
                             rate, seed)
    torch.cuda.synchronize()
    assert tatt.K2_LAUNCHES == n0 + 1
    want = tatt.attention_bwd_reference(q, k, v, key_pad, static, g, lse, H,
                                        scale, rate, seed)
    one_key = k.shape[1] == 1
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.is_contiguous(), name
        if one_key and name == "dk":
            dpn = (tatt._heads(g, H) * tatt._heads(v, H)).sum(-1).abs()
            dpn = dpn / (1.0 - rate)                         # (B, H, Tq)
            qs = tatt._heads(q, H).abs() * scale             # (B, H, Tq, D)
            bound = 2.0 ** -20 * (dpn[..., None] * qs).sum(2)
            assert (tatt._heads(a, H)[:, :, 0].abs() <= bound).all(), name
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


def _problem(tq, tk, seed=4, b=3, dtype=torch.bfloat16):
    """q (column view of a fused QKV when self-attention, else its own
    tensor), k/v views of a fused KV, random masks, g, at Tq x Tk, in
    ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if tq == tk:
        qkv = torch.randn(b, tq, 3 * H * D, device="cuda", generator=gen)
        q, k, v = qkv.to(dtype).split(H * D, dim=-1)
    else:
        q = torch.randn(b, tq, H * D, device="cuda", generator=gen).to(dtype)
        kv = torch.randn(b, tk, 2 * H * D, device="cuda", generator=gen)
        k, v = kv.to(dtype).split(H * D, dim=-1)
    rng = np.random.default_rng(seed)
    pad = (rng.random((b, tk)) > 0.3).astype(np.int32)
    pad[0] = 1
    static = (rng.random((tq, tk)) > 0.8).astype(np.int32)
    g = torch.randn(b, tq, H * D, device="cuda", generator=gen).to(dtype)
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
                                   (200, 17), (1, 200), (200, 1), (63, 65)])
def test_k2_bf16_tensor_cores_at_tile_edges(tq, tk, rate, dtype):
    """The tensor-core K2 (f32: 3xTF32; bf16) at lengths below, at and past
    its 64-row tiles (200 = 3 x 64 + 8, the model's), self and cross. The
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


def _k1_gates(q, k, v, key_pad, static, got, lse, rate=0.0, seed=0):
    """The tensor-core K1 in q's dtype against its plain version: f32
    (3xTF32) out and lse within atol 1e-5 of ``attention_reference`` (the
    module's note says why no relative term); bf16 out within 1e-2 (1 +
    |plain|) of the bf16-dots plain version and 2e-2 (1 + |plain|) of the
    f32-dots one, its lse within 1e-5 (1 + |lse|) of the bf16-dots plain
    lse."""
    h = q.shape[-1] // D
    args = (q, k, v, key_pad, static, h, 1.0 / math.sqrt(D), True, rate,
            seed)
    assert got.dtype == q.dtype and got.is_contiguous()
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()
    if q.dtype == torch.float32:
        want, want_lse = tatt.attention_reference(*args)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0, msg="out")
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0,
                                   msg="lse")
        return
    want, want_lse = tatt.attention_reference(*args,
                                              dots_dtype=torch.bfloat16)
    _within(got, want, 1e-2, "out")
    _within(lse, want_lse, 1e-5, "lse")
    _within(got, tatt.attention_reference(*args)[0], 2e-2, "out f32")


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
    (batch, row tile), drawing the next head's keep bits beside the
    current head's products; the smaller tests run one head a block."""
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
                                        (51200, 256), (51199, 256)])
def test_k3_k4_match_plain(rows, width, dtype):
    """K3 and K4 against ``layer_norm`` / ``layer_norm_bwd_reference``:
    odd row counts (ragged warps and blocks), H = 64, 96, 256, 1024; one
    row; the training step's 3,200 (B=16) and 51,200 (B=256) rows, and
    51,199, whose last K4 tile is short."""
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
@pytest.mark.parametrize("width", [64, 256, 1024])
def test_k4_plan_is_one_wave_on_the_card(width, dtype):
    """The card holds at least one pass-1 block an SM, so the plan's grid
    (at most SMs x blocks an SM) runs in one wave; the kernel refuses a
    plan whose tiles leave rows out or hold none."""
    _need_cuda()
    dt = getattr(torch, dtype)
    lib = tln._lib()
    n_sm, per_sm = tln._k4_card(lib, torch.device("cuda", 0), width, dt)
    assert n_sm == torch.cuda.get_device_properties(0).multi_processor_count
    assert per_sm >= 1
    for rows in (3200, 51200):
        plan = tln._k4_plan(rows, n_sm, per_sm)
        assert min(n_sm, rows) <= plan.grid <= n_sm * per_sm
    x, w, _, dy = _ln_operands(100, width, dt)
    dx = torch.empty_like(x)
    buf = torch.empty(2 * width * 40, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for grid, tile in ((9, 10), (11, 10), (10, 0)):
        rc = lib.mmfm_layernorm_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            buf.data_ptr(), buf[2 * width:].data_ptr(), grid, tile, 100,
            width, 1e-5, tln._DTYPE_CODE[dt], stream)
        assert rc != 0


@pytest.mark.cuda
def test_k3_k4_reject_what_they_do_not_take():
    """Widths that are not a multiple of 32 up to 1024, an output dtype
    other than x's, g in another dtype, and CPU tensors raise."""
    _need_cuda()
    for width in (48, 2048):
        x, w, b, dy = _ln_operands(8, width, torch.float32)
        with pytest.raises(ValueError):
            tln.layernorm_fwd(x, w, b)
        with pytest.raises(ValueError):
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
    ln = tln.LayerNorm(48).cuda()
    old = tln.PALLAS_LAYERNORM
    tln.PALLAS_LAYERNORM = "full"
    try:
        with pytest.raises(ValueError):
            ln(torch.randn(4, 48, device="cuda"))
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
