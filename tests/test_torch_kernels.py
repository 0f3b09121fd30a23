"""The port's CUDA kernels on the card, against their plain versions.

Imports torch and the port only (no JAX), so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the repository's ``tests/conftest.py`` sets up JAX.)
Tests marked ``cuda`` skip without a card. K1 tolerances: f32 atol 1e-5
(online vs two-pass softmax, same f32 products), bf16 atol 2e-2 (one bf16
rounding of the output on each side), lse atol 1e-5. K2 (f32 only):
atol 1e-5 on dq/dk/dv (the same f32 products summed per thread in key or
query order against cuBLAS's blocked order). Dropout runs on the same
Philox bits on both sides, so the tolerances hold at rate 0.4 too.
"""

import math

import numpy as np
import pytest
import torch

from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt

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
    want, want_lse = tatt.attention_reference(q, k, v, key_pad, static, H,
                                              scale, with_lse=True)
    atol = 1e-5 if dt == torch.float32 else 2e-2
    assert got.dtype == dt and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
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
    with pytest.raises(TypeError):               # K2 is f32 only
        qb = q.bfloat16()
        tatt.attention_bwd(qb, qb, qb, key_pad, static, qb,
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
def test_k1_philox_bits_match_philox_keep():
    """Read K1's keep mask back: q = 0 and all keys attended make every
    probability 1/Tk; V's rows are one-hot per head (Tk = D = 32), so
    out[b, q, h*D + k] = keep[b, h, q, k] / (1 - rate) / Tk."""
    _need_cuda()
    tk, rate, seed = D, 0.4, 123456789
    q = torch.zeros(B, T, H * D, device="cuda")
    v = torch.eye(D, device="cuda").repeat(1, H).expand(B, tk, H * D)
    k = torch.zeros(B, tk, H * D, device="cuda")
    key_pad = torch.ones(B, tk, dtype=torch.int32, device="cuda")
    static = torch.zeros(T, tk, dtype=torch.int32, device="cuda")
    out, _ = tatt.attention_fwd(q, k, v.contiguous(), key_pad, static, H,
                                1.0, dropout_rate=rate, seed=seed)
    got = out.reshape(B, T, H, D).transpose(1, 2) > 0
    want = tatt.philox_keep(seed, B, H, T, tk, rate, device="cuda")
    assert torch.equal(got, want)
    assert 0.5 < want.float().mean().item() < 0.7


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
