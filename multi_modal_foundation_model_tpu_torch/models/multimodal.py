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
  masks. The recompute runs each layer whole: torch would stop it at the
  layer's last saved tensor, which without dropout comes before the MLP's
  down projection and with dropout after it, so a step's products would
  depend on the rate (early stop is turned off where the layers draw no
  dropout; with dropout nothing it skips is a product).
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
- **Session stitching** (``n_sessions > 1``, JAX :233-254, :439-452,
  :499-518): the ``ap`` tokenizers and head become session-stitched stacks
  (``SessionStitchedTokenizer``/``SessionStitchedHead``) indexed by the
  forward's ``session_id`` (a host int, or a one-element int tensor on the
  device, so one captured step serves every session), and a session
  embedding (``session_emb``, N(0, 1)) is added to the ``ap`` tokens'
  encoder and decoder embeddings. ``ap`` inputs narrower than ``N_max`` (a
  width bucket) run on static slices of the stacks, the head predicting
  ``n_in`` channels. ``space_attn_mask`` (B, N) takes padded neurons out
  of the ``ap`` loss. Per-sample ``(B,)`` session ids (session-mixed
  batches, JAX :442-448, :468-480): each sample runs its own session's
  stitched rows (batched GEMMs over gathered rows, ``ops/session_rows.py``,
  whose backward sums repeated ids in a fixed order), its own session
  embedding, and its tokens are zeroed by its own token-mask row, not row
  0 (the region draws are per sample there). A one-element id is the
  batch's session: row-0 zeroing, bit for bit as before.
- **Data parallelism** (``parallel/``; the mesh ``shard_module`` sets as
  ``self.mesh``): the forward gets this data rank's rows of the global
  batch and computes what the single-process forward computes on them.
  The masker draws the global rows' draws (``row0``); the token zeroing
  reads the GLOBAL row 0 (broadcast from data rank 0 over the data
  group; with per-sample session ids each sample's own row, on its rank);
  the loss divides the local masked sum by the global masked
  count (``mod_n`` summed over the data group, JAX :528-535) and is then
  summed over the data group with an identity backward, so its value is
  the global loss on every rank and its gradient this rank's part of the
  global gradient: the trainer SUMS gradients over the data group. The
  mean of per-rank means (DDP's default) would be another loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..ops.attention import MaskSpec, create_context_mask
from ..ops.layernorm import LayerNorm
from ..ops.losses import masked_mse, masked_poisson_nll
from ..ops.masking import (MaskParams, RegionSets, apply_mask, host_draws,
                           mask_is_drawn, region_batch)
from ..ops.session_rows import session_rows
from ..parallel.mesh import all_reduce_, broadcast_, reduce_from_group
from ..utils.device import DeviceLike, resolve_device
from ..utils.rng import SeedPath, seed_table
from .layers import (Dense, DecoderLayer, EncoderLayer, ModalityTokenizer,
                     SessionStitchedHead, SessionStitchedTokenizer,
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

    @classmethod
    def from_config(cls, cfg, n_channels: Dict[str, int],
                    avail_mod: Sequence[str] = ("ap", "behavior"),
                    **overrides) -> "MultiModalConfig":
        """From a loaded mm.yaml node, as JAX's
        ``MultiModalConfig.from_config`` (``models/multimodal.py:135``);
        ``compute.compute_dtype`` and ``compute.attn_impl`` are the port's
        string fields (``param_dtype`` is f32 in both packages)."""
        enc_t = cfg.encoder.transformer
        dec_t = cfg.decoder.transformer
        emb = cfg.encoder.embedder
        compute = cfg.get("compute", {}) or {}
        compute_dtype = str(compute.get("compute_dtype", "float32"))
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute.compute_dtype {compute_dtype!r}: "
                             f"one of {sorted(_COMPUTE_DTYPES)}")
        kw = dict(
            avail_mod=tuple(avail_mod),
            n_channels=dict(n_channels),
            max_F=int(emb["max_F"]),
            hidden_size=int(enc_t["hidden_size"]),
            n_enc_layers=int(enc_t["n_layers"]),
            n_dec_layers=int(dec_t["n_layers"]),
            n_heads=int(enc_t["n_heads"]),
            inter_size=int(enc_t["inter_size"]),
            act=enc_t["act"],
            use_scalenorm=bool(enc_t["use_scalenorm"]),
            attention_bias=bool(enc_t["attention_bias"]),
            mlp_bias=bool(enc_t["mlp_bias"]),
            dropout=float(enc_t["dropout"]),
            fixup_init=bool(enc_t["fixup_init"]),
            n_modality=int(emb["n_modality"]),
            mult=int(emb["mult"]),
            embed_act=emb["act"],
            embed_scale=float(emb["scale"]) if emb["scale"] is not None
            else float(enc_t["hidden_size"]) ** 0.5,
            embed_bias=bool(emb["bias"]),
            embed_dropout=float(emb["dropout"]),
            use_pos=bool(emb["pos"]),
            decoder_sep_mask=bool(cfg.decoder["decoder_sep_mask"]),
            decoder_causal_mask=bool(cfg.decoder["decoder_causal_mask"]),
            context_forward=int(cfg.context["forward"]),
            context_backward=int(cfg.context["backward"]),
            mask_params=MaskParams.from_config(cfg.masker),
            mask_mode=cfg.masker["mode"],
            force_active=bool(cfg.masker["force_active"]),
            attn_impl=compute.get("attn_impl", "pallas"),
            compute_dtype=compute_dtype,
        )
        # per-modality loss weights, reachable from the command line as
        # --set model.mod_loss_weights.behavior=20
        lw = cfg.get("mod_loss_weights", None)
        if lw:
            kw["mod_loss_weights"] = {k: float(v) for k, v in dict(lw).items()}
        kw.update(overrides)
        return cls(**kw)

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
    when ``config.fixup_init`` (``models/layers.py``); the stitched stacks
    U(+-1/sqrt(fan_in)) of their own."""

    def __init__(self, config: MultiModalConfig, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mc = config
        dev = resolve_device(device)
        if mc.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {mc.compute_dtype!r} not in "
                             f"{tuple(_COMPUTE_DTYPES)}")
        self.config = mc
        self.compute_dtype = cdt = _COMPUTE_DTYPES[mc.compute_dtype]
        H = mc.hidden_size
        self.stitched = mc.n_sessions > 1

        def tokenizer(mod):
            if self.stitched and mod == "ap":
                return SessionStitchedTokenizer(
                    mc.n_sessions, mc.n_channels[mod], H, mc.mult,
                    mc.embed_act, mc.embed_scale, mc.embed_bias,
                    mc.embed_dropout, cdt)
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
                dec, out=(SessionStitchedHead(mc.n_sessions,
                                              mc.n_channels[mod], H)
                          if self.stitched and mod == "ap"
                          else nn.Linear(H, mc.n_channels[mod])))
        if self.stitched:
            self.session_emb = nn.Embedding(mc.n_sessions, H)

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
            out = self.decoder_embeddings[mod].out
            if isinstance(out, nn.Linear):
                lecun_normal_(out, gen)
        for m in self.modules():
            if isinstance(m, (SessionStitchedTokenizer,
                              SessionStitchedHead)):
                m.reset_stitched_(gen)
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
        batch = region_batch(regions)
        draws = np.stack([
            host_draws(int(table[2 * i]), mp, entry[0],
                       regions if mod == "ap" else None, batch)
            if entry is not None and mask_is_drawn(mp, entry[0], entry[1])
            else host_draws(0, mp, None, batch=batch)
            for i, (mod, entry) in enumerate(zip(self.config.avail_mod,
                                                 plan))])
        return table, draws

    def step_seeds(self, seed: int, plan: Sequence[MaskPlan],
                   regions: Optional[RegionSets], device) -> StepSeeds:
        """``host_seeds`` uploaded to ``device`` (eagerly)."""
        table, draws = self.host_seeds(seed, plan, regions)
        return StepSeeds(torch.from_numpy(table).to(device),
                         torch.from_numpy(draws).to(device))

    def _session_tensor(self, session_id, device, batch: int
                        ) -> torch.Tensor:
        """A stitched forward's session ids as an int tensor on ``device``:
        one element (the batch's session), or ``(batch,)`` (a session a
        sample). Host ints and arrays are copied there, eagerly."""
        if session_id is None:
            raise ValueError("a session-stitched model needs a session_id")
        if not isinstance(session_id, torch.Tensor):
            session_id = torch.as_tensor(np.asarray(session_id),
                                         dtype=torch.int64).to(device)
        if session_id.numel() == 1:
            return session_id.reshape(1)
        if session_id.shape != (batch,):
            raise ValueError(f"session ids of shape {tuple(session_id.shape)}"
                             f" for a batch of {batch}")
        return session_id

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
        mesh = getattr(self, "mesh", None)
        corrupted, mask = apply_mask(
            keys, d.inputs, self.config.mask_params, mode, regions=regions,
            active=active, draws=draws,
            row0=0 if mesh is None else mesh.d * d.inputs.shape[0],
            data_group=None if mesh is None else mesh.data_group)
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
                seed: Union[int, StepSeeds, None] = None,
                session_id: Union[int, torch.Tensor, None] = None,
                space_attn_mask: Optional[torch.Tensor] = None
                ) -> MultiModalOutput:
        """``masking_mode``: None, a mode name, or a host int into
        ``mtm_modes``. ``seed``: the step's ``StepSeeds`` or a host int,
        keying the masker and (with ``training``) dropout; required
        whenever a mask is sampled. ``session_id`` (stitched models only,
        required there): a host int or a one-element int tensor on the
        device (the batch's session), or ``(B,)`` ids, a session a sample
        (with ``regions`` from ``RegionTable.select`` of the same ids).
        ``space_attn_mask`` (B, N_in): 0 marks padded ``ap`` channels,
        which carry no loss."""
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
        first = mod_inputs[mc.avail_mod[0]].inputs
        sid = (self._session_tensor(session_id, first.device, first.shape[0])
               if self.stitched else None)
        per_sample = sid is not None and sid.numel() > 1

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
            seeds_e = seed_at(drop, 2 * M + 2 * i)
            seeds_d = seed_at(drop, 2 * M + 2 * i + 1)
            if sid is not None and mod == "ap":
                s_emb = (session_rows(self.session_emb.weight,
                                      sid)[:, None, :]   # (B, 1, H) f32
                         if per_sample else self.session_emb(sid))  # (1, H)
                e_emb = e_emb + s_emb
                d_emb = d_emb + s_emb
                tokens_e.append(enc(x, sid, seeds_e))
                tokens_d.append(dec(x, sid, seeds_d))
            else:
                tokens_e.append(enc(x, seeds_e))
                # decoder tokens are embedded from the inputs too
                tokens_d.append(dec(x, seeds_d))
            embs_e.append(e_emb)
            embs_d.append(d_emb)

        enc_tokens = torch.cat(tokens_e, dim=1)          # (B, M*T, H)
        dec_tokens = torch.cat(tokens_d, dim=1)
        enc_emb = torch.cat(embs_e, dim=1).to(cdt)       # summed in f32
        dec_emb = torch.cat(embs_d, dim=1).to(cdt)
        token_mask = torch.cat(token_masks, dim=1)        # (B, M*T)
        attn_token = torch.cat(attn_tokens, dim=1)

        # token zeroing by each group's first row, or by each sample's own
        # row for per-sample session ids (module docstring)
        B = token_mask.shape[0]
        G = B if per_sample else token_zero_groups
        if G < 1 or B % G:
            raise ValueError(f"batch {B} is not {G} equal groups")
        lead = token_mask.reshape(G, B // G, -1)[:, :1]
        mesh = getattr(self, "mesh", None)
        if mesh is not None and mesh.dp > 1 and not per_sample:
            if G != 1:
                raise NotImplementedError(
                    "token zeroing by groups under data parallelism")
            # the global batch's row 0 lies on data rank 0
            lead = broadcast_(lead.clone(), mesh.data_group, mesh.m)
        keep = (1 - lead).expand(G, B // G, -1).reshape(B, -1)
        zero = keep.to(enc_tokens.dtype)[:, :, None]
        enc_tokens = enc_tokens * zero
        dec_tokens = dec_tokens * zero

        enc_attn = self._encoder_attn_mask(attn_token)
        dec_attn = self._decoder_attn_mask(attn_token)

        remat = training and mc.remat_layers and torch.is_grad_enabled()
        # without dropout in the layers, the recompute runs them whole as
        # with it (module docstring)
        early_stop = drop is not None and mc.dropout > 0

        def run(layer, *args):
            if remat:
                # the layer's seed-table slice is an argument: the
                # recompute replays its dropout draws, so the default RNG
                # state is not needed
                with (contextlib.nullcontext() if early_stop
                      else set_checkpoint_early_stop(False)):
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
            y_mod = y[:, i * T:(i + 1) * T]
            if sid is not None and mod == "ap":
                # the head's width follows the (bucket-narrowed) input's
                preds = head(y_mod, sid,
                             n_out=mod_inputs[mod].inputs.shape[-1]).float()
            else:
                preds = head(y_mod).float()
            targets = gts[mod].float()
            elem_mask = spike_masks[mod]
            if elem_mask is None:
                elem_mask = token_masks[i][:, :, None].expand(targets.shape)
            if mod == "ap" and space_attn_mask is not None:
                # padded neurons (a session's N_max padding) carry no loss
                elem_mask = elem_mask * space_attn_mask[:, None, :].to(
                    elem_mask.dtype)
            if MODALITY_LOSS.get(mod, "mse") == "poisson_nll":
                loss_sum, n = masked_poisson_nll(preds, targets, elem_mask)
            else:
                loss_sum, n = masked_mse(preds, targets, elem_mask)
            mod_loss[mod] = loss_sum
            mod_n[mod] = n
            mod_preds[mod] = preds
            mod_targets[mod] = targets

        # under DP the local sums over the GLOBAL counts (mod_loss and
        # mod_n_examples stay this rank's)
        group = None if mesh is None else mesh.data_group
        n_all = mod_n
        if group is not None:
            counts = all_reduce_(torch.stack([mod_n[m] for m in mc.avail_mod]),
                                 group)
            n_all = dict(zip(mc.avail_mod, counts.unbind()))
        if mc.mod_loss_weights is not None:
            loss = sum(mc.mod_loss_weights.get(mod, 1.0)
                       * mod_loss[mod] / n_all[mod].clamp_min(1.0)
                       for mod in mc.avail_mod)
        else:
            total_n = sum(n_all.values())
            loss = sum(mod_loss.values()) / total_n.clamp_min(1.0)
        loss = reduce_from_group(loss, group)

        return MultiModalOutput(
            loss=loss, mod_loss=mod_loss, mod_n_examples=mod_n,
            mod_preds=mod_preds, mod_targets=mod_targets)
