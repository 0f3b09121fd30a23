"""The MultiModal masked autoencoder (``nn.Module``): training and eval.

Port of ``multi_modal_foundation_model_tpu/models/multimodal.py``:

- **Static token layout.** Tokens concatenate per modality in
  ``avail_mod`` order, ``max_F`` each, so a modality's tokens are a static
  slice.
- **Batch-uniform token zeroing by row 0** (``:468-480`` of the JAX
  module): one mask per batch zeroes the tokens that batch element 0's
  mask selects, for the whole batch. ``token_zero_groups=G`` treats the
  batch as G equal groups, each zeroed by ITS OWN first row — what
  ``jax.vmap`` of one forward per group does. The eval sweep relies on it:
  it runs many held-out-neuron variants in one batch, and zeroing by the
  whole batch's row 0 would let variant 0 (neuron 0 held out) flip the
  token mask of every other variant.
- **The masker** (``_resolve_masks``, JAX :316-363): a ``masking_mode``
  (a mode name, or a host int into ``mtm_modes``, the MtM menu) corrupts
  the inputs and takes precedence over ``eval_mask``; ``eval_mask=None``
  samples a targets mask with ``config.mask_mode``. Modalities without
  region info (behavior) run ``temporal`` where the menu names a region
  mode (JAX :345-347).
- **Randomness from one seed table.** ``seed`` keys the masker and, with
  ``training=True``, every dropout site. It is a ``StepSeeds``: the step's
  seed table (``utils/rng.py``; one int64 entry per random site, in the
  order of ``seed_paths``: the masker's two keys per modality, embedding
  dropout per tokenizer, each layer's attention and MLP sites) and the
  masker's host draws (``host_seeds``), both on the device; or a host int
  (the trainer folds its step into its seed, as JAX folds ``fold_in(key,
  step)``), from which the forward builds and uploads them. Every draw
  reads its key from its table entry on the device, so a CUDA graph of a
  training step, replayed with another step's table, draws that step's
  bits. Nothing random is drawn without a seed.
- **Remat.** With ``training=True`` and ``remat_layers`` each transformer
  layer runs under ``torch.utils.checkpoint(use_reentrant=False)``, as
  JAX's ``nn.remat`` (:281-287); its slice of the seed table is an
  argument of the checkpointed call, so the recompute replays the same
  masks.
- **Attention masks as (key_pad, static) decompositions**: encoder
  ``eye | pad``, decoder pad / causal / modality-separation, fed to the
  fused attention (K1/K2 on the card).
- **Losses**: Poisson NLL (log-input, no Stirling) on spikes + MSE on
  behavior, masked (by the masker's element mask where there is one),
  combined as the sum over modalities divided by the total masked count,
  or by ``mod_loss_weights``.
- **Compute dtype** (``compute_dtype``, "float32" or "bfloat16"; mm.yaml
  runs bf16): the casts sit where JAX puts them (:432-509). Inputs go to
  the compute dtype; the embedding tables stay f32 and their sums are cast
  after the concatenation; the tokenizers, the layers and the context
  projection compute in it; ``encoder_norm`` runs on ``x.float()`` and is
  cast back, ``decoder_norm`` runs on ``y.float()`` and stays f32, so the
  heads are f32 Linears; preds and targets are f32. Parameters stay f32.

Session stitching (``n_sessions > 1``) is a later slice and raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import MaskSpec, create_context_mask
from ..ops.layernorm import LayerNorm
from ..ops.losses import masked_mse, masked_poisson_nll
from ..ops.masking import (MaskParams, RegionSets, apply_mask, host_draws,
                           mask_is_drawn)
from ..utils.device import DeviceLike, resolve_device
from ..utils.rng import SeedPath, seed_table
from .layers import (Dense, DecoderLayer, EncoderLayer, ModalityTokenizer,
                     fixup_init_, lecun_normal_, reset_parameters_, seed_at)

MODALITY_LOSS = {"ap": "poisson_nll", "behavior": "mse"}
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ModalityInput:
    """Per-modality model input."""

    inputs: torch.Tensor                     # (B, T, C)
    targets: torch.Tensor                    # (B, T, C)
    attn_mask: torch.Tensor                  # (B, T) int
    timestamps: torch.Tensor                 # (B, T) int
    eval_mask: Optional[torch.Tensor] = None  # (B, T, C) int


class StepSeeds(NamedTuple):
    """A step's randomness on the device: the seed table (``(n_sites,)``
    int64, ``MultiModal.seed_paths`` order) and the masker's host draws
    (``(n_modalities, n_draws)`` f32, ``ops.masking.host_draws``)."""

    table: torch.Tensor
    draws: torch.Tensor


# one modality's mask plan: (mode, active, corrupt the inputs)
MaskPlan = Optional[Tuple[str, bool, bool]]


@dataclasses.dataclass
class MultiModalOutput:
    loss: torch.Tensor
    mod_loss: Dict[str, torch.Tensor]
    mod_n_examples: Dict[str, torch.Tensor]
    mod_preds: Dict[str, torch.Tensor]
    mod_targets: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MultiModalConfig:
    """Static model hyperparameters; field for field the JAX package's
    ``MultiModalConfig``, so both read each other's ``model_config.json``.
    ``compute_dtype`` is the dtype's name. ``attn_impl="pallas"`` runs the
    hand-written kernels on the card, ``"xla"`` the plain versions."""

    avail_mod: Tuple[str, ...] = ("ap", "behavior")
    n_channels: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"ap": 668, "behavior": 2})
    max_F: int = 100
    hidden_size: int = 256
    n_enc_layers: int = 5
    n_dec_layers: int = 5
    n_heads: int = 8
    inter_size: int = 512
    act: str = "gelu"
    use_scalenorm: bool = False
    attention_bias: bool = True
    mlp_bias: bool = True
    dropout: float = 0.4
    fixup_init: bool = True
    # embedder
    n_modality: int = 2
    mult: int = 2
    embed_act: str = "softsign"
    embed_scale: float = 1.0
    embed_bias: bool = True
    embed_dropout: float = 0.2
    use_pos: bool = True
    # decoder options
    decoder_sep_mask: bool = False
    decoder_causal_mask: bool = False
    context_forward: int = -1
    context_backward: int = -1
    # masker
    mask_params: MaskParams = dataclasses.field(default_factory=MaskParams)
    mask_mode: str = "temporal"
    force_active: bool = True
    mod_loss_weights: Optional[Dict[str, float]] = None
    # compute
    attn_impl: str = "pallas"
    compute_dtype: str = "float32"
    share_modality_embeddings: bool = True
    remat_layers: bool = True
    n_sessions: int = 1

    def to_json_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> "MultiModalConfig":
        d = dict(d)
        d["avail_mod"] = tuple(d["avail_mod"])
        d["compute_dtype"] = d.get("compute_dtype", "float32")
        if d["compute_dtype"] not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {d['compute_dtype']!r}")
        mp = dict(d.get("mask_params", {}))
        for k in ("channels", "timesteps"):
            if mp.get(k) is not None:
                mp[k] = tuple(mp[k])
        d["mask_params"] = MaskParams(**mp)
        return cls(**d)


class _Embeddings(nn.Module):
    """Holder giving the reference names ``<side>_embeddings.{m}.embedder``
    (and ``decoder_embeddings.{m}.out`` for the output head)."""

    def __init__(self, embedder: ModalityTokenizer,
                 out: Optional[nn.Linear] = None):
        super().__init__()
        self.embedder = embedder
        if out is not None:
            self.out = out


class MultiModal(nn.Module):
    """MultiMAE-style encoder-decoder over concatenated modality tokens.

    Built on ``device`` (default: the card; ``device="cpu"`` must be asked
    for) with JAX's initialization drawn from ``generator`` (default: a
    generator seeded with 0): torch-default Linears and N(0, 1) tables,
    ``lecun_normal_`` context projection and output heads, fixup-rescaled
    when ``config.fixup_init`` (``models/layers.py``)."""

    def __init__(self, config: MultiModalConfig, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mc = config
        dev = resolve_device(device)
        if mc.n_sessions != 1:
            raise NotImplementedError(
                "session stitching (n_sessions > 1) is a later slice")
        if mc.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {mc.compute_dtype!r} not in "
                             f"{tuple(_COMPUTE_DTYPES)}")
        self.config = mc
        self.compute_dtype = cdt = _COMPUTE_DTYPES[mc.compute_dtype]
        H = mc.hidden_size

        def tokenizer(mod):
            return ModalityTokenizer(mc.n_channels[mod], H, mc.mult,
                                     mc.embed_act, mc.embed_scale,
                                     mc.embed_bias, mc.embed_dropout, cdt)

        self.encoder_embeddings = nn.ModuleDict()
        self.decoder_embeddings = nn.ModuleDict()
        for mod in mc.avail_mod:
            enc, dec = tokenizer(mod), tokenizer(mod)
            enc.mod_emb = nn.Embedding(mc.n_modality, H)
            # one shared table: the reference's state_dict carries it under
            # both the encoder and the decoder key
            dec.mod_emb = (enc.mod_emb if mc.share_modality_embeddings
                           else nn.Embedding(mc.n_modality, H))
            if mc.use_pos:
                enc.pos_embed = nn.Embedding(mc.max_F, H)
                dec.pos_embed = nn.Embedding(mc.max_F, H)
            self.encoder_embeddings[mod] = _Embeddings(enc)
            # the heads read decoder_norm's f32 output: f32 Linears
            self.decoder_embeddings[mod] = _Embeddings(
                dec, out=nn.Linear(H, mc.n_channels[mod]))

        self.encoder = nn.ModuleList(
            EncoderLayer(mc, mc.attn_impl, cdt)
            for _ in range(mc.n_enc_layers))
        self.encoder_norm = LayerNorm(H, eps=1e-5)
        self.decoder_proj_context = Dense(H, H, dtype=cdt)
        self.decoder = nn.ModuleList(
            DecoderLayer(mc, mc.attn_impl, cdt)
            for _ in range(mc.n_dec_layers))
        self.decoder_norm = LayerNorm(H, eps=1e-5)

        gen = (generator if generator is not None
               else torch.Generator().manual_seed(0))
        reset_parameters_(self, gen)
        # JAX builds these two as plain MXUDense: flax's default init
        lecun_normal_(self.decoder_proj_context, gen)
        for mod in mc.avail_mod:
            lecun_normal_(self.decoder_embeddings[mod].out, gen)
        if mc.fixup_init:
            for layer in self.encoder:
                fixup_init_(layer, mc.n_enc_layers)
            for layer in self.decoder:
                fixup_init_(layer, mc.n_dec_layers)
        self.to(dev)
        self.seed_paths = self._build_seed_paths()

    # ------------------------------------------------------------------
    # the seed table
    # ------------------------------------------------------------------

    def _build_seed_paths(self) -> List[SeedPath]:
        """Every random site's fold_in path under a step's seed, in table
        order: per modality i the masker's (k_mask, k_corrupt) under
        fold_in(seed, 0), i; then under fold_in(seed, 1) (dropout) the
        encoder and decoder tokenizers of each modality (0, i) / (1, i),
        the encoder layers (2, li) and the decoder layers (3, li), each
        with its ``SEED_PATHS``."""
        mc = self.config
        M = len(mc.avail_mod)
        paths: List[SeedPath] = []
        for i in range(M):
            paths += [((0,), (i,), (0,)), ((0,), (i,), (1,))]
        for i in range(M):
            paths += [((1,), (0, i)), ((1,), (1, i))]
        for li in range(mc.n_enc_layers):
            paths += [((1,), (2, li)) + p for p in EncoderLayer.SEED_PATHS]
        for li in range(mc.n_dec_layers):
            paths += [((1,), (3, li)) + p for p in DecoderLayer.SEED_PATHS]
        self._enc_off = 4 * M
        self._dec_off = 4 * M + len(EncoderLayer.SEED_PATHS) * mc.n_enc_layers
        return paths

    def mask_plan(self, has_eval_mask: Sequence[bool], masking_mode=None,
                  mtm_modes: Sequence[str] = (),
                  regions: Optional[RegionSets] = None,
                  training: bool = False) -> List[MaskPlan]:
        """Per modality, what the masker runs (JAX ``_resolve_masks``): a
        ``masking_mode`` (a mode name, or a host int into ``mtm_modes``)
        corrupts the inputs and takes precedence over ``eval_mask``;
        without an ``eval_mask`` a targets mask of ``config.mask_mode`` is
        sampled; else nothing (None). Modalities without region info
        (behavior) run ``temporal`` where the menu names a region mode."""
        mc = self.config
        active = bool(mc.force_active) or training
        plan: List[MaskPlan] = []
        for mod, has_mask in zip(mc.avail_mod, has_eval_mask):
            has_regions = regions is not None and mod == "ap"
            if masking_mode is None:
                plan.append(None if has_mask else (mc.mask_mode, active,
                                                   False))
            elif isinstance(masking_mode, str):
                plan.append((masking_mode, active, True))
            else:                         # host int into the MtM menu
                mode = mtm_modes[int(masking_mode)]
                if not has_regions and mode.endswith("region"):
                    mode = "temporal"
                # JAX's menu path (``apply_mask_by_id``) always masks,
                # whatever force_active and training say
                plan.append((mode, True, True))
        return plan

    def host_seeds(self, seed: int, plan: Sequence[MaskPlan],
                   regions: Optional[RegionSets] = None):
        """(seed table (n_sites,) int64, masker draws (n_modalities,
        n_draws) f32) of one step under the host int ``seed``."""
        mp = self.config.mask_params
        table = seed_table(seed, self.seed_paths)
        draws = np.stack([
            host_draws(int(table[2 * i]), mp, entry[0],
                       regions if mod == "ap" else None)
            if entry is not None and mask_is_drawn(mp, entry[0], entry[1])
            else host_draws(0, mp, None)
            for i, (mod, entry) in enumerate(zip(self.config.avail_mod,
                                                 plan))])
        return table, draws

    def step_seeds(self, seed: int, plan: Sequence[MaskPlan],
                   regions: Optional[RegionSets], device) -> StepSeeds:
        """``host_seeds`` uploaded to ``device`` (eagerly)."""
        table, draws = self.host_seeds(seed, plan, regions)
        return StepSeeds(torch.from_numpy(table).to(device),
                         torch.from_numpy(draws).to(device))

    # ------------------------------------------------------------------
    # mask plumbing
    # ------------------------------------------------------------------

    def _resolve_masks(self, mod: str, d: ModalityInput, plan: MaskPlan,
                       regions: Optional[RegionSets],
                       keys: Optional[torch.Tensor],
                       draws: Optional[torch.Tensor]):
        """(inputs, possibly corrupted; token_mask (B, T) int32; element
        mask (B, T, C) int32 or None) of one modality under its ``plan``,
        with its masker ``keys`` ([k_mask, k_corrupt]) and host ``draws``
        from the step's seeds (JAX ``_resolve_masks``)."""
        attn = d.attn_mask.to(torch.int32)
        if plan is None:
            return (d.inputs, d.eval_mask[:, :, 0].to(torch.int32) & attn,
                    None)
        mode, active, corrupt = plan
        if regions is not None and mod != "ap":
            regions = None
        if regions is not None \
                and regions.region_ids.shape[-1] > d.inputs.shape[-1]:
            regions = dataclasses.replace(
                regions, region_ids=regions.region_ids[
                    ..., :d.inputs.shape[-1]])
        corrupted, mask = apply_mask(keys, d.inputs, self.config.mask_params,
                                     mode, regions=regions, active=active,
                                     draws=draws)
        if corrupt:
            return corrupted, mask[:, :, 0] & attn, mask
        return d.inputs, mask[:, :, 0] & attn, None

    # ------------------------------------------------------------------
    # attention-mask construction
    # ------------------------------------------------------------------

    @staticmethod
    def _encoder_attn_mask(attn_tokens: torch.Tensor) -> MaskSpec:
        """eye OR key-padding (the context mask is all-ones)."""
        N = attn_tokens.shape[1]
        return MaskSpec(key_pad=attn_tokens,
                        static=torch.eye(N, dtype=torch.int32,
                                         device=attn_tokens.device))

    def _decoder_attn_mask(self, attn_tokens: torch.Tensor) -> MaskSpec:
        """pad / causal / modality-separation terms as (key_pad, static)."""
        mc = self.config
        N = attn_tokens.shape[1]
        dev = attn_tokens.device
        static = None
        key_pad = attn_tokens
        if mc.decoder_causal_mask:
            static = create_context_mask(0, -1, N, device=dev)
            key_pad = None                 # causal replaces the pad term
        if mc.decoder_sep_mask:
            # built on the device: a step copies nothing from the host
            mod_of_token = torch.arange(len(mc.avail_mod),
                                        device=dev).repeat_interleave(
                                            mc.max_F)
            sep = (mod_of_token[:, None] != mod_of_token[None, :]).to(
                torch.int32)
            static = sep if static is None else (static.bool()
                                                 | sep.bool()).int()
        if mc.decoder_causal_mask and key_pad is None and static is not None:
            # causal-only: no pad term may re-admit padded keys
            key_pad = torch.zeros_like(attn_tokens)
        return MaskSpec(key_pad=key_pad, static=static)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def forward(self, mod_inputs: Dict[str, ModalityInput],
                masking_mode=None, mtm_modes: Sequence[str] = (),
                regions: Optional[RegionSets] = None,
                training: bool = False, token_zero_groups: int = 1,
                seed: Union[int, StepSeeds, None] = None
                ) -> MultiModalOutput:
        """``masking_mode``: None, a mode name, or a host int into
        ``mtm_modes``. ``seed``: the step's ``StepSeeds`` or a host int,
        keying the masker and (with ``training``) dropout; required
        whenever a mask is sampled."""
        mc = self.config
        cdt = self.compute_dtype
        T = mc.max_F
        plan = self.mask_plan(
            [mod_inputs[m].eval_mask is not None for m in mc.avail_mod],
            masking_mode, mtm_modes, regions, training)
        if seed is None:
            if any(p is not None for p in plan):
                raise ValueError("sampling a mask needs a seed")
            if training and (mc.dropout > 0 or mc.embed_dropout > 0):
                raise ValueError("training with dropout needs a seed")
        elif not isinstance(seed, StepSeeds):
            seed = self.step_seeds(int(seed), plan, regions,
                                   mod_inputs[mc.avail_mod[0]].inputs.device)
        table = None if seed is None else seed.table
        drop = table if training else None
        M = len(mc.avail_mod)

        tokens_e, tokens_d, embs_e, embs_d = [], [], [], []
        token_masks, attn_tokens, gts, spike_masks = [], [], {}, {}
        for i, mod in enumerate(mc.avail_mod):
            d = mod_inputs[mod]
            inputs, token_mask, spike_masks[mod] = self._resolve_masks(
                mod, d, plan[i], regions, seed_at(table, 2 * i, 2),
                None if seed is None else seed.draws[i])
            token_masks.append(token_mask)
            attn_tokens.append(d.attn_mask.to(torch.int32))
            gts[mod] = d.targets

            enc = self.encoder_embeddings[mod].embedder
            dec = self.decoder_embeddings[mod].embedder
            ts = d.timestamps.long()
            mod_id = torch.full_like(ts, i)
            e_emb, d_emb = enc.mod_emb(mod_id), dec.mod_emb(mod_id)
            if mc.use_pos:
                e_emb = e_emb + enc.pos_embed(ts)
                d_emb = d_emb + dec.pos_embed(ts)
            x = inputs.to(cdt)
            tokens_e.append(enc(x, seed_at(drop, 2 * M + 2 * i)))
            # decoder tokens are embedded from the inputs too
            tokens_d.append(dec(x, seed_at(drop, 2 * M + 2 * i + 1)))
            embs_e.append(e_emb)
            embs_d.append(d_emb)

        enc_tokens = torch.cat(tokens_e, dim=1)          # (B, M*T, H)
        dec_tokens = torch.cat(tokens_d, dim=1)
        enc_emb = torch.cat(embs_e, dim=1).to(cdt)       # summed in f32
        dec_emb = torch.cat(embs_d, dim=1).to(cdt)
        token_mask = torch.cat(token_masks, dim=1)        # (B, M*T)
        attn_token = torch.cat(attn_tokens, dim=1)

        # token zeroing by each group's first row (module docstring)
        B = token_mask.shape[0]
        G = token_zero_groups
        if G < 1 or B % G:
            raise ValueError(f"batch {B} is not {G} equal groups")
        first = token_mask.reshape(G, B // G, -1)[:, :1]
        keep = (1 - first).expand(G, B // G, -1).reshape(B, -1)
        zero = keep.to(enc_tokens.dtype)[:, :, None]
        enc_tokens = enc_tokens * zero
        dec_tokens = dec_tokens * zero

        enc_attn = self._encoder_attn_mask(attn_token)
        dec_attn = self._decoder_attn_mask(attn_token)

        remat = training and mc.remat_layers and torch.is_grad_enabled()

        def run(layer, *args):
            if remat:
                # the layer's seed-table slice is an argument: the
                # recompute replays its dropout draws, so the default RNG
                # state is not needed
                return checkpoint(layer, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return layer(*args)

        x = enc_tokens + enc_emb
        n_enc, n_dec = (len(EncoderLayer.SEED_PATHS),
                        len(DecoderLayer.SEED_PATHS))
        for li, layer in enumerate(self.encoder):
            x = run(layer, x, enc_attn,
                    seed_at(drop, self._enc_off + n_enc * li, n_enc))
        x = self.encoder_norm(x.float()).to(cdt)

        context = self.decoder_proj_context(x) + enc_emb
        y = dec_tokens + dec_emb
        for li, layer in enumerate(self.decoder):
            y = run(layer, y, context, dec_attn, enc_attn,
                    seed_at(drop, self._dec_off + n_dec * li, n_dec))
        y = self.decoder_norm(y.float())                  # stays f32

        mod_loss, mod_n, mod_preds, mod_targets = {}, {}, {}, {}
        for i, mod in enumerate(mc.avail_mod):
            head = self.decoder_embeddings[mod].out
            preds = head(y[:, i * T:(i + 1) * T]).float()
            targets = gts[mod].float()
            elem_mask = spike_masks[mod]
            if elem_mask is None:
                elem_mask = token_masks[i][:, :, None].expand(targets.shape)
            if MODALITY_LOSS.get(mod, "mse") == "poisson_nll":
                loss_sum, n = masked_poisson_nll(preds, targets, elem_mask)
            else:
                loss_sum, n = masked_mse(preds, targets, elem_mask)
            mod_loss[mod] = loss_sum
            mod_n[mod] = n
            mod_preds[mod] = preds
            mod_targets[mod] = targets

        if mc.mod_loss_weights is not None:
            loss = sum(mc.mod_loss_weights.get(mod, 1.0)
                       * mod_loss[mod] / mod_n[mod].clamp_min(1.0)
                       for mod in mc.avail_mod)
        else:
            total_n = sum(mod_n.values())
            loss = sum(mod_loss.values()) / total_n.clamp_min(1.0)

        return MultiModalOutput(
            loss=loss, mod_loss=mod_loss, mod_n_examples=mod_n,
            mod_preds=mod_preds, mod_targets=mod_targets)
