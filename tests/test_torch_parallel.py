"""The port's ``parallel/`` package against the JAX package's, and the
draw offsets that let a rank draw its slice of the single-process draw.

- ``mesh_shape`` / ``Mesh`` against JAX ``build_mesh`` on the 8 virtual CPU
  devices of ``conftest.py``: the same (dp, tp) or None, the same axis
  names, rank = d * tp + m as JAX's ``reshape(n_dp, tp)``.
- Placement: for every parameter of the full-width port model and of the
  session-stitched model, the dimension the port shards over ``model``
  equals the one JAX's ``spec_for`` gives the matching flax leaf (a Dense
  kernel ``(in, out)`` is the port's weight ``(out, in)``), at tp = 2, 4
  and 8 (at 8 the behavior tokenizer's 4-wide intermediate does not
  divide: replicated on both sides).
- The heads rule: an attention whose heads do not divide the axis stays
  whole in the port, where JAX shards its projections and runs its kernel
  unsharded (``_tp_mesh_axis``).
- Draws: the plain K1/K2 keep bits, the plain attention forward and
  backward, and the Philox bytes and uniforms at offsets equal the slices
  of the global draw, and shards draw distinct bits (JAX's
  ``test_tp_dropout_seed_distinct_per_shard``); the masker's draws at a
  row offset equal the global mask's rows.
- The loss denominator: the sum of the ranks' local sums over the global
  count is the single-device loss; the mean of the ranks' own means is
  not, when their counts differ.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import FULL, TOY
from multi_modal_foundation_model_tpu.models import multimodal as jmm
from multi_modal_foundation_model_tpu.ops import attention as jatt
from multi_modal_foundation_model_tpu.parallel import build_mesh as jbuild
from multi_modal_foundation_model_tpu.parallel import spec_for as jspec
from multi_modal_foundation_model_tpu.parallel.partition import _path_str
from multi_modal_foundation_model_tpu_torch import parallel as tpar
from multi_modal_foundation_model_tpu_torch.models import multimodal as tmm
from multi_modal_foundation_model_tpu_torch.ops import attention as tatt
from multi_modal_foundation_model_tpu_torch.ops import masking as tmask
from multi_modal_foundation_model_tpu_torch.ops import random as trand
from multi_modal_foundation_model_tpu_torch.utils.convert import (
    params_from_jax)


def _fake_mesh(dp, tp, rank=0):
    """A ``Mesh`` of no process group: the placement rules and offsets
    read only its shape and coordinates."""
    return tpar.Mesh(dp=dp, tp=tp, rank=rank, data_group=None,
                     model_group=None)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", [(-1, 1), (2, 1), (8, 1), (-1, 2), (2, 2),
                                   (1, 2), (4, 2), (2, 4), (-1, 8), (1, 1),
                                   (3, 2)])
def test_mesh_shape_matches_jax_build_mesh(dp, tp):
    jmesh = jbuild(dp=dp, tp=tp)
    shape = tpar.mesh_shape(len(jax.devices()), dp, tp)
    if jmesh is None:
        assert shape is None
        return
    n_dp = jmesh.devices.shape[0]
    assert shape == (n_dp, tp)
    mesh = _fake_mesh(*shape)
    assert mesh.axis_names == jmesh.axis_names
    assert tpar.model_axis_size(mesh) == (tp if tp > 1 else 1)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(n_dp, tp)
    for rank in range(n_dp * tp):
        r = _fake_mesh(n_dp, tp, rank)
        assert ids[r.d, r.m] == rank            # row-major, as JAX


def test_mesh_shape_refuses_tp_beyond_the_world():
    with pytest.raises(ValueError, match="exceeds"):
        tpar.mesh_shape(4, 1, 8)
    with pytest.raises(ValueError):
        jbuild(dp=1, tp=16)


def test_one_process_has_no_mesh():
    assert tpar.build_mesh() is None and tpar.build_mesh(1, 1) is None
    assert tpar.model_axis_size(None) == 1
    for dp, tp in ((2, 1), (1, 2), (-1, 2)):   # more ranks than the world
        with pytest.raises(ValueError, match="world has 1"):
            tpar.build_mesh(dp, tp)


def test_shard_rows_keeps_the_rank_rows():
    x = np.arange(8 * 3).reshape(8, 3)
    got = [tpar.shard_rows(x, _fake_mesh(2, 2, r)) for r in range(4)]
    np.testing.assert_array_equal(got[0], x[:4])
    np.testing.assert_array_equal(got[1], x[:4])      # same d, other m
    np.testing.assert_array_equal(got[3], x[4:])
    with pytest.raises(ValueError, match="split"):
        tpar.shard_rows(x[:7], _fake_mesh(2, 1))
    batch = tpar.shard_batch({"a": x, "n_real": 8}, _fake_mesh(2, 1, 1),
                             keys=("a",))
    assert batch["n_real"] == 8 and batch["a"].shape == (4, 3)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _marked_jax_params(cfg):
    """The flax param tree of ``cfg`` (shapes by ``eval_shape``), each leaf
    filled with its own index, and {index: (path, shape)}."""
    model = jmm.MultiModal(dataclasses.replace(cfg, attn_impl="xla"))
    B, T = 2, cfg.max_F

    def inputs():
        def mi(n):
            x = np.zeros((B, T, n), np.float32)
            return jmm.ModalityInput(
                inputs=x, targets=x, attn_mask=np.ones((B, T), np.int32),
                timestamps=np.tile(np.arange(T), (B, 1)),
                eval_mask=np.zeros((B, T, n), np.int32))
        return {m: mi(cfg.n_channels[m]) for m in cfg.avail_mod}

    kw = ({"session_id": np.asarray(0, np.int32)} if cfg.n_sessions > 1
          else {})
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), inputs(), **kw))["params"]
    index = {}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    filled = []
    for i, (path, leaf) in enumerate(leaves):
        index[i] = (_path_str(path), leaf.shape)
        filled.append(np.full(leaf.shape, i, np.float32))
    return jax.tree_util.tree_unflatten(treedef, filled), index


@pytest.mark.parametrize("n_sessions", [1, 3], ids=["single", "stitched"])
def test_placements_match_jax_spec_for(n_sessions):
    geometry = dict(FULL, n_sessions=n_sessions)
    jcfg = jmm.MultiModalConfig(**geometry)
    params, index = _marked_jax_params(jcfg)
    tcfg = tmm.MultiModalConfig(**geometry)
    sd = params_from_jax(params, tcfg)
    model = tmm.MultiModal(tcfg, device="cpu")
    checked = 0
    for tp in (2, 4, 8):
        jmesh = jbuild(dp=8 // tp, tp=tp)
        got = tpar.module_placements(model, _fake_mesh(8 // tp, tp))
        for name in got:
            path, shape = index[int(sd[name].reshape(-1)[0])]
            spec = tuple(jspec(path, shape, jmesh))
            spec += (None,) * (len(shape) - len(spec))
            want = spec.index("model") if "model" in spec else None
            # a Dense kernel (in, out) is the port's weight (out, in)
            if want is not None and path.endswith("/kernel") \
                    and len(shape) == 2:
                want = 1 - want
            assert got[name] == want, (tp, name, path)
            checked += want is not None
    assert checked > 0
    if n_sessions == 1:     # the behavior tokenizer: 4-wide intermediate
        behavior = "encoder_embeddings.behavior.embedder.token_embed.weight"
        assert tpar.module_placements(model, _fake_mesh(4, 2))[behavior] == 0
        assert tpar.module_placements(model, _fake_mesh(1, 8))[behavior] \
            is None


def test_heads_not_divisible_keeps_the_attention_whole():
    """Two heads over tp=4: JAX shards the projections by the rules and
    runs its kernel unsharded (``_tp_mesh_axis``); the port keeps the
    attention whole, so its rules and its kernel call agree. The MLP
    still shards."""
    geometry = dict(TOY, n_heads=2)
    model = tmm.MultiModal(tmm.MultiModalConfig(**geometry), device="cpu")
    mesh = _fake_mesh(1, 4)
    got = tpar.module_placements(model, mesh)
    for blk in ("attn", "cross_attn"):
        for n in ("query", "key", "value", "out_proj"):
            assert got[f"decoder.0.{blk}.{n}.weight"] is None
    assert got["encoder.0.attn.query.weight"] is None
    assert got["encoder.0.mlp.up_proj.weight"] == 0
    assert got["encoder.0.mlp.down_proj.weight"] == 1
    # JAX: the rules shard, the kernel falls back
    jmesh = jbuild(dp=2, tp=4)
    assert tuple(jspec("encoder_0/attn/query/kernel", (64, 64), jmesh)) == \
        (None, "model")
    with jatt.tp_attention(jmesh):
        assert jatt._tp_mesh_axis(n_heads=2, hidden=64)[2] == 1
        assert jatt._tp_mesh_axis(n_heads=4, hidden=64)[2] == 4


def test_shard_module_cuts_and_full_state_dict_restores():
    """In place: each sharded parameter is its rank's slice; gathering the
    ranks' slices along ``tp_dim`` gives the single-device tensor back."""
    cfg = tmm.MultiModalConfig(**TOY)
    whole = tmm.MultiModal(cfg, device="cpu").state_dict()
    parts = []
    for rank in range(2):
        model = tmm.MultiModal(cfg, device="cpu")
        placements = tpar.shard_module(model, _fake_mesh(1, 2, rank))
        attn = model.encoder[0].attn
        assert attn.n_heads == 2 and attn.head0 == 2 * rank
        assert attn.query.tp == "col" and attn.out_proj.tp == "row"
        assert attn.query.out_features == 32
        parts.append((placements, model.state_dict()))
    for name, t in whole.items():
        dim = parts[0][0].get(name)
        if dim is None:
            torch.testing.assert_close(parts[1][1][name], t, rtol=0, atol=0)
        else:
            torch.testing.assert_close(
                torch.cat([p[1][name] for p in parts], dim), t, rtol=0,
                atol=0)
    # the session-stitched tokenizer: its (S, N, inter) kernel and (S,
    # inter) bias keep the rank's columns of inter, column-parallel; the
    # projection row-parallel; the stitched head replicated
    cfg = tmm.MultiModalConfig(**TOY, n_sessions=2)
    whole = tmm.MultiModal(cfg, device="cpu").state_dict()
    tok = "encoder_embeddings.ap.embedder."
    for rank in range(2):
        stitched = tmm.MultiModal(cfg, device="cpu")
        placements = tpar.shard_module(stitched, _fake_mesh(1, 2, rank))
        emb = stitched.encoder_embeddings["ap"].embedder
        assert emb.tp == "col" and emb.projection.tp == "row"
        assert placements[tok + "token_embed_kernel"] == 2
        assert placements[tok + "token_embed_bias"] == 1
        assert placements["decoder_embeddings.ap.out.kernel"] is None
        inter = whole[tok + "token_embed_bias"].shape[1]
        cols = slice(rank * inter // 2, (rank + 1) * inter // 2)
        torch.testing.assert_close(emb.token_embed_kernel.data,
                                   whole[tok + "token_embed_kernel"][..., cols],
                                   rtol=0, atol=0)
        torch.testing.assert_close(emb.token_embed_bias.data,
                                   whole[tok + "token_embed_bias"][:, cols],
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# draw offsets
# ---------------------------------------------------------------------------

def test_keep_bits_at_offsets_are_slices_and_distinct():
    B, H, Tq, Tk, seed = 4, 8, 9, 13, 1234
    whole = tatt.philox_keep(seed, B, H, Tq, Tk, 0.4)
    shards = {}
    for d in range(2):
        for m in range(4):
            got = tatt.philox_keep(seed, 2, 2, Tq, Tk, 0.4, b0=2 * d,
                                   h0=2 * m)
            torch.testing.assert_close(
                got, whole[2 * d:2 * d + 2, 2 * m:2 * m + 2], rtol=0, atol=0)
            shards[(d, m)] = got
    bits = {k: tatt.philox_bits(seed, 2, 2, Tq, Tk, b0=2 * k[0],
                                h0=2 * k[1]) for k in shards}
    keys = list(bits)
    assert all(not torch.equal(bits[a], bits[b])
               for i, a in enumerate(keys) for b in keys[i + 1:])


@pytest.mark.parametrize("rows,heads", [((0, 2), (0, 2)), ((2, 4), (2, 4)),
                                        ((1, 3), (1, 3))])
def test_plain_attention_at_offsets_is_the_global_slice(rows, heads):
    """The plain K1 and K2 on rows and heads of a call, with their offsets,
    give that slice of the whole call's output, lse and gradients, dropout
    0.4 included."""
    g = torch.Generator().manual_seed(3)
    B, T, H, D = 4, 11, 4, 32
    q, k, v, go = (torch.randn(B, T, H * D, generator=g) for _ in range(4))
    key_pad = torch.ones(B, T, dtype=torch.int32)
    key_pad[-1, 7:] = 0
    static = torch.eye(T, dtype=torch.int32)
    scale, rate, seed = D ** -0.5, 0.4, 99
    out, lse = tatt.attention_reference(q, k, v, key_pad, static, H, scale,
                                        True, rate, seed)
    grads = tatt.attention_bwd_reference(q, k, v, key_pad, static, go, lse,
                                         H, scale, rate, seed)
    (b0, b1), (h0, h1) = rows, heads

    def cut(x):
        return x[b0:b1, :, h0 * D:h1 * D]

    off = (b0, h0)
    o, l_ = tatt.attention_reference(cut(q), cut(k), cut(v), key_pad[b0:b1],
                                     static, h1 - h0, scale, True, rate,
                                     seed, draw_offset=off)
    gr = tatt.attention_bwd_reference(cut(q), cut(k), cut(v),
                                      key_pad[b0:b1], static, cut(go), l_,
                                      h1 - h0, scale, rate, seed,
                                      draw_offset=off)
    torch.testing.assert_close(o, cut(out), rtol=0, atol=1e-6)
    torch.testing.assert_close(l_, lse[b0:b1, h0:h1], rtol=0, atol=1e-6)
    for a, b in zip(gr, grads):
        torch.testing.assert_close(a, cut(b), rtol=0, atol=1e-6)
    # the module path passes the offsets through
    got = tatt.multi_head_attention(
        cut(q), cut(k), cut(v), h1 - h0,
        mask_spec=tatt.MaskSpec(key_pad=key_pad[b0:b1], static=static),
        dropout_rate=rate, seed=seed, draw_offset=off)
    torch.testing.assert_close(got, cut(out), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_attention_output_dropout_precedes_out_proj(dp, tp):
    """JAX's order at dropout 0.4 (``Attention``, :409-413): the output
    dropout on the attention output, then ``out_proj``, built here from the
    plain draws. One process gives it; each dp x tp rank gives its rows,
    its partial ``out_proj`` products summed over its model ranks (no
    group here, so each rank adds the bias once). The other order,
    dropout after ``out_proj``, is another function."""
    import copy

    from multi_modal_foundation_model_tpu_torch.models import layers as tlay

    B, T, H, n_heads, rate = 4, 9, 64, 4, 0.4
    torch.manual_seed(0)
    whole = torch.nn.ModuleDict({"blk": torch.nn.ModuleDict(
        {"attn": tlay.Attention(H, n_heads, True, dropout=rate)})})
    attn = whole["blk"]["attn"]
    x = torch.randn(B, T, H, generator=torch.Generator().manual_seed(1))
    seeds = torch.tensor([11, 2 ** 40 + 12])
    with torch.no_grad():
        q, k, v = (F.linear(x, lin.weight, lin.bias)
                   for lin in (attn.query, attn.key, attn.value))
        a = tatt.multi_head_attention(q, k, v, n_heads, dropout_rate=rate,
                                      seed=seeds[0:1])
        t, keep = tlay.dropout_keep_threshold(rate)

        def drop(y):
            bits = trand.u8_bits_reference(seeds[1:2], y.shape)
            return torch.where(bits >= t, y / keep, 0.0)

        want = attn.out_proj(drop(a))
        assert not torch.allclose(drop(attn.out_proj(a)), want, atol=1e-3)
        n = B // dp
        got = [0.0] * dp
        for rank in range(dp * tp):
            mesh = _fake_mesh(dp, tp, rank)
            shard = copy.deepcopy(whole)
            tpar.shard_module(shard, mesh)
            sa = shard["blk"]["attn"]
            assert sa.n_heads == n_heads // tp
            rows = slice(mesh.d * n, (mesh.d + 1) * n)
            got[mesh.d] = got[mesh.d] + sa(x[rows], seeds=seeds) \
                - attn.out_proj.bias
        for d in range(dp):
            torch.testing.assert_close(
                got[d] + attn.out_proj.bias, want[d * n:(d + 1) * n],
                rtol=0, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 3, 16, 17, 40_000, 51_201])
def test_philox_draws_at_offsets_are_slices(offset):
    n = 333
    total = offset + n + 5
    for seed in (7, torch.tensor([2 ** 40 + 9])):
        b = trand.u8_bits_reference(seed, (total,), 1)
        u = trand.uniform_reference(seed, (total,), 2)
        torch.testing.assert_close(
            trand.u8_bits(seed, (n,), 1, offset=offset),
            b[offset:offset + n], rtol=0, atol=0)
        torch.testing.assert_close(
            trand.uniform(seed, (n,), 2, offset=offset),
            u[offset:offset + n], rtol=0, atol=0)
    first = trand.u8_bits_reference(7, (2, 200, 256))
    second = trand.u8_bits_reference(7, (2, 200, 256), offset=2 * 200 * 256)
    assert not torch.equal(first, second)


@pytest.mark.parametrize("mode", ["temporal", "neuron", "random",
                                  "intra-region", "causal"])
def test_masker_rows_at_offsets_are_the_global_rows(mode):
    """Under DP a rank's masks are its rows of the single-process masks."""
    rng = np.random.default_rng(0)
    spikes = torch.from_numpy(rng.poisson(1.0, (8, 20, 24)).astype(
        np.float32))
    params = tmask.MaskParams(ratio=0.3, expand_prob=0.5, max_timespan=3)
    regions = tmask.RegionSets.build(rng.integers(0, 4, 24))
    k_mask, k_corrupt = tmask.mask_keys(5)
    draws = torch.from_numpy(tmask.host_draws(k_mask, params, mode, regions))
    keys = torch.tensor([k_mask, k_corrupt])
    whole, wmask = tmask.apply_mask(keys, spikes, params, mode, regions,
                                    draws=draws)
    for d in range(2):
        rows = slice(4 * d, 4 * d + 4)
        got, mask = tmask.apply_mask(keys, spikes[rows], params, mode,
                                     regions, draws=draws, row0=4 * d)
        torch.testing.assert_close(got, whole[rows], rtol=0, atol=0)
        torch.testing.assert_close(mask, wmask[rows], rtol=0, atol=0)


def test_global_denominator_and_the_mean_of_means():
    """Masked sums over ranks whose counts differ: each rank's sum over the
    GLOBAL count, summed, is the single-device loss; the mean of the
    ranks' own means is another loss."""
    from multi_modal_foundation_model_tpu_torch.ops.losses import (
        masked_poisson_nll)
    g = torch.Generator().manual_seed(0)
    preds = torch.randn(8, 20, 24, generator=g)
    targets = torch.poisson(torch.ones(8, 20, 24))
    mask = torch.zeros(8, 20, 24)
    mask[:4, :3] = 1                      # rank 0: few masked elements
    mask[4:, :15] = 1                     # rank 1: many
    s, n = masked_poisson_nll(preds, targets, mask)
    single = s / n
    parts = [masked_poisson_nll(preds[r], targets[r], mask[r])
             for r in (slice(0, 4), slice(4, 8))]
    n_all = sum(p[1] for p in parts)
    assert parts[0][1] != parts[1][1]
    torch.testing.assert_close(sum(p[0] for p in parts) / n_all, single,
                               rtol=1e-6, atol=0)
    mean_of_means = sum(p[0] / p[1] for p in parts) / 2
    assert abs(float(mean_of_means - single)) > 1e-3 * abs(float(single))
