"""Model assembly: a flat list of layers.

Counterpart of ``repro.models.transformer``.  The reference stacks its
layers into groups of the config's layer period and scans over them; here
``params["layers"]`` is a plain list with one dict per layer walked by a
Python loop: ``ln1`` and the mixer (``attn`` for attention layers,
``mamba`` for Mamba layers, ``mixer`` for mLSTM and sLSTM layers), for
whisper's decoder ``ln_cross`` and the cross-attention ``cross``, then
``ln2`` and the FFN block: ``ffn`` (dense), ``moe``, or both for
"moe+dense"; none for xLSTM.  Whisper's encoder is ``params["encoder"]``:
``{"layers": [...], "final_norm"}``, each layer ``ln1``, ``attn``, ``ln2``,
``ffn`` (bidirectional attention, no rope).  A cache is ``{"layers":
[entry, ...]}``: an attention layer's entry is its (B, S, Kh, Dh)
``k``/``v`` pair (whisper's adds the encoder's (B, enc_frames, Kh, Dh)
``ck``/``cv``), a Mamba layer's its state ``{h, conv}``, an mLSTM's ``{C,
n, m}``, an sLSTM's ``{h, c, n, m}``.  Two full-sequence modes share one
code path:

  train    full-sequence forward, no cache
  prefill  full-sequence forward, emits the cache (KV padded to cache_len)

and :func:`decode_step` runs one token at a host int position ``pos``,
writing its K/V into the cache in place (a recurrent layer's entry is
replaced by its new state).  The embedding, each block, its attention
mixer, its FFN or MoE block and the head run inside ``repro_torch.obs``
spans (``model.embed``, ``model.layer``, ``model.attention``,
``model.ffn``, ``model.moe``, ``model.head``), which record only while a
torch profiler does.

Every family runs: ``dense``, ``moe``, ``hybrid`` (jamba), ``ssm``
(xLSTM), ``audio`` (whisper: the batch's ``frames``, (B, enc_frames, d) in
the model's compute dtype, run through the encoder; sinusoidal absolute
positions) and ``vlm`` (pixtral: the batch's ``patches``, (B, n_patches,
d), in front of the tokens, so the text starts at position n_patches).

Parameters that are ``DTensor`` objects (placed by ``launch.shardings``)
run the sharded forward under the active logical rules
(``models.sharding.use_rules``; ROADMAP.md item 13c): the batch given is
this rank's rows, and each block gathers its parameters over the mesh dims
other than ``"model"`` (FSDP over ``"data"``) when it runs, inside the
block, so that a checkpointed block gathers again in its backward and no
block keeps another's.  Along ``"model"`` a block runs on this rank's
shards wherever the rules shard its dim there (heads, FFN hidden units,
experts, Mamba channels, mLSTM heads; the vocabulary of the embedding and
the logits, which come out as this rank's columns); attention whose heads
do not divide (``kv_seq``) runs every head on this rank's slice of the
keys, merged across the ranks by log-sum-exp (``models.attention``); a
block whose dim does not split otherwise (the sLSTM) gathers its
``"model"`` shards too and runs whole on every rank.  The sequence-sharded
layouts are the reference's: a prefill's cache keeps this rank's rows of
its sequence where ``cache_seq`` splits it (:func:`pad_cache_to`), decode
merges the ranks' partials over them, and under Megatron-SP (``sp``, train
mode) the residual between blocks is this rank's rows of the sequence:
each block gathers it before its mixers and its row-parallel products
reduce-scatter it (``launch.collectives``); the final norm and the logits
run on the gathered sequence.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.collectives import (TP, gather_seq, split_seq,
                                            tp_of)
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (DTYPES, embed_init, embed_lookup, ffn,
                                       init_ffn, norm_init, rms_norm,
                                       sinusoidal_positions, unembed_logits)
from repro_torch.models.sharding import (batch_axes, constrain, get_rules,
                                         seq_split, use_rules)


class FrontendInput(NamedTuple):
    """What a family's stub frontend puts in the batch: its ``name``
    (None for a text-only family), its ``rows`` per request, and the
    text's first position ``text_offset`` (a vlm's patches come first)."""
    name: Optional[str]
    rows: int
    text_offset: int


def frontend_input(cfg: ModelConfig) -> FrontendInput:
    """whisper's ``frames`` (enc_frames rows, read by the encoder; the
    text starts at 0) or pixtral's ``patches`` (n_patches rows in front of
    the text)."""
    if cfg.family == "audio":
        return FrontendInput("frames", cfg.enc_frames, 0)
    if cfg.family == "vlm":
        return FrontendInput("patches", cfg.n_patches, cfg.n_patches)
    return FrontendInput(None, 0, 0)


# ----------------------------------------------------------------------- init
def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: DeviceLike = "cuda") -> Dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the ``meta`` device allocates nothing)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    dt = DTYPES[cfg.param_dtype]
    params: Dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                        dev),
                    "final_norm": norm_init(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                       dev)
    cross = cfg.family == "audio"
    params["layers"] = [_init_layer(gen, cfg, cfg.layer_kind(i),
                                    cfg.ffn_kind(i), dev, cross)
                        for i in range(cfg.n_layers)]
    if cross:
        ecfg = _enc_cfg(cfg)
        params["encoder"] = {
            "layers": [_init_layer(gen, ecfg, ecfg.layer_kind(0),
                                   ecfg.ffn_kind(0), dev)
                       for _ in range(cfg.enc_layers)],
            "final_norm": norm_init(cfg.d_model, dev)}
    return params


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """Encoder stack config for enc-dec archs: plain bidirectional
    attention."""
    return dataclasses.replace(cfg, local_global_period=0, sliding_window=0,
                               attn_period=0, slstm_period=0, n_experts=0,
                               rope_theta=0.0)


class _Recurrent(NamedTuple):
    """A recurrent mixer's functions (``models/ssm.py``) and the key of its
    parameters in the layer dict (the reference's)."""
    key: str
    init: Callable
    forward: Callable          # full sequence, optionally with its state
    step: Callable             # one token from a state
    init_state: Callable


_RECURRENT = {
    "mamba": _Recurrent("mamba", ssm_lib.init_mamba, ssm_lib.mamba_forward,
                        ssm_lib.mamba_step, ssm_lib.mamba_init_state),
    "mlstm": _Recurrent("mixer", ssm_lib.init_mlstm, ssm_lib.mlstm_forward,
                        ssm_lib.mlstm_step, ssm_lib.mlstm_init_state),
    "slstm": _Recurrent("mixer", ssm_lib.init_slstm, ssm_lib.slstm_forward,
                        ssm_lib.slstm_step, ssm_lib.slstm_init_state)}


def _init_layer(gen, cfg: ModelConfig, kind: str, fkind: str,
                dev: torch.device, cross: bool = False) -> Dict:
    p: Dict = {"ln1": norm_init(cfg.d_model, dev)}
    if kind in _RECURRENT:
        mixer = _RECURRENT[kind]
        p[mixer.key] = mixer.init(gen, cfg, dev)
    else:
        p["attn"] = attn_lib.init_attention(gen, cfg, dev)
    if cross:
        p["ln_cross"] = norm_init(cfg.d_model, dev)
        p["cross"] = attn_lib.init_attention(gen, cfg, dev)
    if fkind != "none":
        p["ln2"] = norm_init(cfg.d_model, dev)
        if fkind in ("dense", "moe+dense"):
            p["ffn"] = init_ffn(gen, cfg, cfg.d_ff, dev)
        if fkind in ("moe", "moe+dense"):
            p["moe"] = moe_lib.init_moe(gen, cfg, dev)
    return p


# -------------------------------------------------------------- sharded run
class Sharded(NamedTuple):
    """How this rank runs a model whose parameters are ``DTensor``
    objects: the mesh, the active logical rules, the ``"model"`` dim
    (None at one rank or without rules: every block then runs whole), the
    mesh dims that split the batch (their ranks computed different parts
    of every gradient) and their process groups of more than one rank."""
    mesh: object
    rules: Optional[Dict]
    tp: Optional[TP]
    partial: Tuple[str, ...]
    dp_groups: Tuple


def seq_parallel(sh: Optional[Sharded], mode: str) -> Optional[TP]:
    """The ``"model"`` dim's :class:`TP` marked ``seq`` where the residual
    is split along the sequence (Megatron-SP: the rules' ``sp``, train
    mode), else None."""
    if sh is None or sh.tp is None or mode != "train" or \
            sh.rules.get("sp") != "model":
        return None
    return sh.tp._replace(seq=True)


def sharded(params: Dict) -> Optional[Sharded]:
    """The :class:`Sharded` of ``params``, or None for plain tensors."""
    from torch.distributed.tensor import DTensor
    leaf = params["final_norm"]
    if not isinstance(leaf, DTensor):
        return None
    mesh = leaf.device_mesh
    _, rules = get_rules()
    axes = batch_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    groups = tuple(mesh.get_group(a) for a in axes
                   if mesh.size(names.index(a)) > 1)
    return Sharded(mesh, rules, tp_of(mesh) if rules else None, axes,
                   groups)


def model_dim(t) -> Optional[int]:
    """The tensor dim that ``"model"`` shards in the DTensor ``t``."""
    names = tuple(t.device_mesh.mesh_dim_names)
    if "model" not in names:
        return None
    p = t.placements[names.index("model")]
    return p.dim if p.is_shard() else None


def gathered(t, sh: Sharded, keep_model: bool = False) -> torch.Tensor:
    """``t`` gathered over every mesh dim (but ``"model"`` with
    ``keep_model``), its gradient summed over the batch's dims."""
    from repro_torch.launch.shardings import full_tensor
    over = tuple(a for a in sh.mesh.mesh_dim_names
                 if not (keep_model and a == "model"))
    return full_tensor(t, sh.partial, over)


def _block_plan(sh: Sharded, key: str, block: Dict, cfg: ModelConfig,
                kind: str, mode: str):
    """(the leaves of ``block`` kept on this rank's ``"model"`` shard, the
    block's ``tp``): the block runs on local shards where the rules shard
    its dim over ``"model"``; attention under ``kv_seq`` on every head, its
    parameters whole, with the keys split; else whole."""
    tp, rules = sh.tp, sh.rules
    if tp is None:
        return (), None
    if key in ("attn", "cross") and rules["tp_heads"] == "model":
        kv = ("wk", "wv") if rules["tp_kv"] == "model" else ()
        return ("wq", "wo") + kv, tp
    if key in ("attn", "cross") and rules["kv_seq"] == "model":
        return (), tp
    if key == "ffn" and model_dim(block["w_gate"]) == 1:
        return ("w_gate", "w_up", "w_down"), tp
    if key == "moe" and model_dim(block["w_gate"]) == 0:
        return ("w_gate", "w_up", "w_down"), tp
    if key == "mamba" and model_dim(block["conv_b"]) == 0:
        return tuple(k for k in block if k != "in_proj"), tp
    if key == "mixer" and kind == "mlstm":    # its state: value columns
        heads = mode != "decode" and cfg.n_heads % tp.size == 0 and \
            model_dim(block["wq"]) == 1
        return ("wq", "wk", "wv", "w_gate", "w_out") if heads else (), tp
    return (), None


def _gather_layer(lp: Dict, cfg: ModelConfig, kind: str, mode: str,
                  sh: Sharded) -> Tuple[Dict, Dict]:
    """One layer's parameters as plain tensors for this rank, and each
    block's ``tp`` (or None: it runs whole)."""
    out, tps = {}, {}
    for key, block in lp.items():
        if not isinstance(block, dict):                  # a norm
            out[key] = gathered(block, sh)
            continue
        keep, tps[key] = _block_plan(sh, key, block, cfg, kind, mode)
        out[key] = {k: gathered(t, sh, k in keep) for k, t in block.items()}
    return out, tps


def _vocab_table(t, sh: Optional[Sharded]):
    """The embedding / unembedding table for this rank and its ``tp``:
    this rank's rows of the vocabulary where ``"model"`` shards them."""
    if sh is None:
        return t, None
    tp = sh.tp if model_dim(t) == 0 else None
    return gathered(t, sh, tp is not None), tp


# --------------------------------------------------------------------- layers
def _layer_apply(lp: Dict, cfg: ModelConfig, kind: str, fkind: str,
                 x: torch.Tensor, mode: str,
                 positions: Optional[torch.Tensor], cache: Optional[Dict],
                 pos: Optional[int], enc_out: Optional[torch.Tensor] = None,
                 sh: Optional[Sharded] = None
                 ) -> Tuple[torch.Tensor, Dict, Optional[torch.Tensor]]:
    """One block: the mixer, whisper's cross-attention over ``enc_out``
    (decode reads the encoder's k/v from the cache entry instead), then the
    FFN block unless ``fkind`` is "none" (the dense FFN, the MoE FFN, or
    their sum for "moe+dense"), each pre-normed and added to the residual.
    Returns (x, cache entry, the MoE's aux loss or None).  With ``sh``,
    ``lp`` holds ``DTensor`` objects, gathered here (module docstring);
    under Megatron-SP ``x`` is this rank's rows of the sequence, and so is
    the result.  The block runs under ``sh``'s rules: they are
    thread-local, and a checkpointed block's recompute runs on autograd's
    thread for the device."""
    with obs.span("model.layer"):
        if sh is None:
            return _layer_body(lp, cfg, kind, fkind, x, mode, positions,
                               cache, pos, enc_out)
        with use_rules(sh.mesh, sh.rules):
            return _layer_body(lp, cfg, kind, fkind, x, mode, positions,
                               cache, pos, enc_out, sh)


def _layer_body(lp: Dict, cfg: ModelConfig, kind: str, fkind: str,
                x: torch.Tensor, mode: str,
                positions: Optional[torch.Tensor], cache: Optional[Dict],
                pos: Optional[int], enc_out: Optional[torch.Tensor] = None,
                sh: Optional[Sharded] = None
                ) -> Tuple[torch.Tensor, Dict, Optional[torch.Tensor]]:
    tps: Dict = {}
    if sh is not None:
        lp, tps = _gather_layer(lp, cfg, kind, mode, sh)
    seq = seq_parallel(sh, mode)
    if seq is not None:
        tps = {k: None if t is None else seq for k, t in tps.items()}

    def whole(x):                  # the block's input: the whole sequence
        return x if seq is None else gather_seq(x, seq)

    def own(y, key):               # a mixer's output: this rank's rows
        return y if seq is None or tps.get(key) is not None else \
            split_seq(y, seq)
    h = rms_norm(whole(x), lp["ln1"], cfg.norm_eps)
    entry: Dict = {}
    if kind in _RECURRENT:
        mixer = _RECURRENT[kind]
        mp = lp[mixer.key]
        kw = {} if tps.get(mixer.key) is None else {"tp": tps[mixer.key]}
        if mode == "decode":
            y, entry = mixer.step(mp, cfg, h, cache, **kw)
        elif mode == "prefill":
            y, entry = mixer.forward(mp, cfg, h, return_state=True, **kw)
        else:
            y = own(mixer.forward(mp, cfg, h, **kw), mixer.key)
    else:
        with obs.span("model.attention"):
            if mode == "decode":
                y, entry = attn_lib.decode_attention(
                    lp["attn"], cfg, h, cache, pos, kind, tp=tps.get("attn"))
            elif mode == "prefill":
                y, (entry["k"], entry["v"]) = attn_lib.multi_head_attention(
                    lp["attn"], cfg, h, positions, kind, return_kv=True,
                    tp=tps.get("attn"))
            else:
                y = own(attn_lib.multi_head_attention(
                    lp["attn"], cfg, h, positions, kind,
                    tp=tps.get("attn")), "attn")
    x = x + y
    if "cross" in lp:                                      # whisper decoder
        h = rms_norm(whole(x), lp["ln_cross"], cfg.norm_eps)
        if mode == "decode":
            y, _ = attn_lib.decode_attention(lp["cross"], cfg, h, {}, pos,
                                             "attn",
                                             cross_kv=(cache["ck"],
                                                       cache["cv"]),
                                             tp=tps.get("cross"))
        else:
            y, (ck, cv) = attn_lib.multi_head_attention(
                lp["cross"], cfg, h, positions, "attn", causal=False,
                kv_x=enc_out, return_kv=True, tp=tps.get("cross"))
            y = own(y, "cross")
            if mode == "prefill":
                entry["ck"], entry["cv"] = ck, cv
        x = x + y
    if fkind == "none":
        return x, entry, None
    h = rms_norm(whole(x), lp["ln2"], cfg.norm_eps)
    y, aux = None, None
    if "ffn" in lp:
        with obs.span("model.ffn"):
            y = own(ffn(lp["ffn"], cfg, h, tp=tps.get("ffn")), "ffn")
    if "moe" in lp:
        dp = sh.dp_groups if sh is not None and mode == "train" else ()
        with obs.span("model.moe"):
            r = moe_lib.moe_ffn(lp["moe"], cfg, h, tp=tps.get("moe"),
                                dp_groups=dp)
            out = own(r["out"], "moe")
        y = out if y is None else y + out
        aux = r["aux_loss"]
    x = x + y
    if cfg.seq_parallel_residual and mode == "train":
        # Megatron-SP: the residual lives split along the sequence over
        # "model" between blocks, this rank's rows of it
        x = constrain(x, "dp", "sp", None,
                      full=(None, positions.shape[1], cfg.d_model))
    return x, entry, aux


def _logits(params: Dict, cfg: ModelConfig, x: torch.Tensor,
            sh: Optional[Sharded] = None) -> torch.Tensor:
    with obs.span("model.head"):
        norm = params["final_norm"] if sh is None else \
            gathered(params["final_norm"], sh)
        x = rms_norm(x, norm, cfg.norm_eps)
        table, tp = _vocab_table(
            params["embed"] if cfg.tie_embeddings else params["unembed"], sh)
        return unembed_logits(x, table, cfg, tp=tp)


def encode_audio(params: Dict, cfg: ModelConfig,
                 frames: torch.Tensor,
                 sh: Optional[Sharded] = None) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, F, d): the sinusoidal
    table added, then per layer bidirectional attention and the FFN, each
    pre-normed and added to the residual, then the final norm.

    ``frames`` must come in the model's compute dtype (``cfg.dtype``): the
    reference's scans fail on any other (a float32 encoder output promotes
    a bf16 decoder's residual stream; ``repro/launch/specs.py:41`` gives
    bf16 models bf16 frames), so another dtype raises ``TypeError``."""
    want = DTYPES[cfg.dtype]
    if frames.dtype != want:
        raise TypeError(
            f"{cfg.name}: frames must be in the model's compute dtype "
            f"{want}, got {frames.dtype}; the reference's scan raises a "
            f"TypeError for these (repro/launch/specs.py:41 gives frames in "
            f"the model's dtype)")
    ecfg = _enc_cfg(cfg)
    b, f = frames.shape[:2]
    x = frames + sinusoidal_positions(f, cfg.d_model, frames.device
                                      ).to(frames.dtype)[None]
    positions = torch.arange(f, device=x.device).expand(b, f)
    for lp in params["encoder"]["layers"]:
        tps: Dict = {}
        if sh is not None:
            lp, tps = _gather_layer(lp, ecfg, "attn", "train", sh)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn_lib.multi_head_attention(lp["attn"], ecfg, h, positions,
                                              "attn", causal=False,
                                              tp=tps.get("attn"))
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(lp["ffn"], cfg, h, tp=tps.get("ffn"))
    norm = params["encoder"]["final_norm"]
    return rms_norm(x, norm if sh is None else gathered(norm, sh),
                    cfg.norm_eps)


def _embed_input(params: Dict, cfg: ModelConfig, batch: Dict,
                 sh: Optional[Sharded] = None) -> torch.Tensor:
    """Token embeddings, after the vlm's patches (cast to their dtype),
    with the absolute positions added when ``cfg.abs_positions``."""
    with obs.span("model.embed"):
        table, tp = _vocab_table(params["embed"], sh)
        x = embed_lookup(table, batch["tokens"], cfg, tp=tp)
        del table
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        if cfg.abs_positions:
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device
                                         ).to(x.dtype)[None]
        return x


def forward(params: Dict, cfg: ModelConfig, batch: Dict, mode: str = "train"
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence forward over ``batch["tokens"]`` (B, S) (and the
    audio family's ``frames``, the vlm's ``patches``, which take positions
    0..n_patches-1 before the tokens), positions 0..S-1.  Returns (logits
    (B, S, V), the MoE layers' summed aux loss (float32; 0 without MoE),
    cache or None).

    With ``cfg.remat == "full"`` in train mode under grad, each decoder
    layer runs under ``torch.utils.checkpoint`` (the reference wraps each
    scanned layer group in ``jax.checkpoint``): its activations are
    recomputed in the backward, so each attention layer launches its
    forward kernel twice per step; the numbers do not change."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', got {mode!r}")
    sh = sharded(params)
    enc_out = None
    if cfg.family == "audio":
        enc_out = encode_audio(params, cfg, batch["frames"], sh)
    x = constrain(_embed_input(params, cfg, batch, sh), "dp", None, None,
                  full=(None, None, cfg.d_model))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    seq = seq_parallel(sh, mode)
    if seq is not None:                  # Megatron-SP: this rank's rows
        x = split_seq(x, seq)
    entries: List[Dict] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = _layer_apply
    if cfg.remat == "full" and mode == "train" and torch.is_grad_enabled():
        layer = functools.partial(checkpoint, _layer_apply,
                                  use_reentrant=False)
    for i, lp in enumerate(params["layers"]):
        x, entry, a = layer(lp, cfg, cfg.layer_kind(i), cfg.ffn_kind(i), x,
                            mode, positions, None, None, enc_out, sh)
        entries.append(entry)
        if a is not None:
            aux = aux + a
    cache = {"layers": entries} if mode == "prefill" else None
    if seq is not None:
        x = gather_seq(x, seq)
    return _logits(params, cfg, x, sh), aux, cache


def check_cache_split(rows: int, split) -> None:
    """Raise ``ValueError`` unless a cache of ``rows`` splits evenly over
    the ranks of ``split`` (its ``cache_seq`` dims), as the reference's
    ``pjit`` refuses such a cache."""
    if rows % split.n:
        raise ValueError(
            f"a cache of {rows} rows does not split evenly over the "
            f"{split.n} ranks of its sequence (cache_seq); the reference's "
            f"pjit refuses it")


def pad_cache_to(cache: Dict, cfg: ModelConfig, cache_len: int,
                 split=None) -> Dict:
    """Grow prefill KV entries (B, P, Kh, Dh) to (B, cache_len, Kh, Dh) with
    zeros (new tensors, so decoding in place never writes the prefill's).
    Recurrent states (and a Mamba layer's conv window) have no sequence
    axis and pass unchanged, and so do whisper's encoder k/v (``ck``,
    ``cv``).  With ``split`` (a ``models.sharding.SeqSplit``: the cache's
    sequence split over ranks), ``cache_len`` is the global length, which
    must divide evenly over the split (else ``ValueError``, as the
    reference's ``pjit`` refuses such a cache), and each entry keeps this
    rank's rows of the grown cache."""
    if split is not None:
        check_cache_split(cache_len, split)
    lo, hi = (0, cache_len) if split is None else split.bounds(cache_len)

    def grow(t: torch.Tensor) -> torch.Tensor:
        if split is None and cache_len <= t.shape[1]:
            return t
        out = t.new_zeros((t.shape[0], hi - lo) + tuple(t.shape[2:]))
        n = max(0, min(hi, t.shape[1]) - lo)
        out[:, :n] = t[:, lo:lo + n]
        return out

    return {"layers": [{key: grow(t) if key in ("k", "v") else t
                        for key, t in entry.items()}
                       for entry in cache["layers"]]}


# --------------------------------------------------------------------- decode
def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1) int; pos: host int, shared by the batch (for a vlm the
    text's positions follow the n_patches patch rows).  Returns (logits (B,
    1, V), cache); the cache is updated in place.  With
    ``cfg.abs_positions`` the token gets row ``pos`` of the sinusoidal
    table of ``cache_seq_len`` rows, as in the reference.

    On ``DTensor`` parameters, a cache of ``DTensor`` entries placed by
    ``launch.shardings.cache_shardings`` and ``token`` the global batch's
    (a plain tensor every rank holds, or a ``DTensor`` placed on the
    batch's dims): the step runs on this rank's rows and shards, the cache's
    entries are updated in place (a recurrent state replaced, keeping its
    placements) and the logits come back as a ``DTensor`` placed over the
    batch's dims and, where ``"model"`` shards the vocabulary, over it (the
    reference's jitted ``serve_step``, ``repro/launch/dryrun.py:139-147``),
    a cache split along its sequence (``cache_seq``) included: the rank
    that holds row ``pos`` writes it, and the ranks' partial attentions
    are merged (``models.attention.decode_attention``)."""
    sh = serving_sharded(params, cfg)
    layers = cache["layers"]
    split = seq_split("cache_seq") if sh is not None else None
    if split is not None:
        check_cache_split(cache_seq_len(cfg, cache), split)
    if sh is not None:
        placed = layers
        layers = [{k: t.to_local() for k, t in e.items()} for e in layers]
        token = local_input(token, sh)
    with obs.span("model.embed"):
        table, tp = _vocab_table(params["embed"], sh)
        x = embed_lookup(table, token, cfg, tp=tp)
        del table
        if cfg.abs_positions:
            x = x + sinusoidal_positions(1, cfg.d_model, x.device,
                                         start=int(pos)).to(x.dtype)[None]
    for i, lp in enumerate(params["layers"]):
        x, layers[i], _ = _layer_apply(lp, cfg, cfg.layer_kind(i),
                                       cfg.ffn_kind(i), x, "decode", None,
                                       layers[i], int(pos), None, sh)
    logits = _logits(params, cfg, x, sh)
    if sh is None:
        return logits, cache
    for i, entry in enumerate(layers):
        placed[i] = {k: _like(t, placed[i][k]) for k, t in entry.items()}
    return place_logits(logits, cfg, sh), cache


# ------------------------------------------------------ sharded prefill/decode
def serving_sharded(params: Dict, cfg: ModelConfig) -> Optional[Sharded]:
    """:func:`sharded` for prefill and decode, which place the cache as
    ``cache_shardings`` does (so they need the logical rules)."""
    sh = sharded(params)
    if sh is not None and sh.rules is None:
        raise ValueError("sharded prefill and decode place their cache by "
                         "the logical rules: run them under "
                         "models.sharding.use_rules")
    return sh


def local_input(t: torch.Tensor, sh: Sharded) -> torch.Tensor:
    """This rank's rows of ``t``: a ``DTensor``'s local tensor, or the
    rows of a plain tensor of the global batch."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.sharding import local_rows
    if isinstance(t, DTensor):
        return t.to_local()
    return local_rows({"t": t}, sh.mesh, sh.partial)["t"]


def _like(local: torch.Tensor, ref) -> "torch.distributed.tensor.DTensor":
    from torch.distributed.tensor import DTensor
    if isinstance(ref, DTensor) and local is ref.to_local():
        return ref
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def place_logits(logits: torch.Tensor, cfg: ModelConfig, sh: Sharded):
    """This rank's logits as a ``DTensor``: rows over the batch's dims,
    columns over ``"model"`` where it shards the vocabulary."""
    from repro_torch.launch.shardings import PartitionSpec, as_dtensor
    vocab = "model" if logits.shape[-1] != cfg.vocab_size else None
    return as_dtensor(logits, sh.mesh,
                      PartitionSpec(sh.partial or None, None, vocab))


def place_cache(cache: Dict, cfg: ModelConfig, sh: Sharded) -> Dict:
    """A prefill's cache of this rank's rows and shards as ``DTensor``
    entries placed by ``cache_shardings``."""
    from repro_torch.launch.shardings import as_dtensor, cache_specs_of
    specs = cache_specs_of(cfg, sh.rules)["layers"]
    return {"layers": [{k: as_dtensor(t, sh.mesh, spec[k])
                        for k, t in entry.items()}
                       for entry, spec in zip(cache["layers"], specs)]}


def cache_seq_len(cfg: ModelConfig, cache: Dict) -> int:
    """The KV cache's length; 0 for a model with no attention layer."""
    for entry in cache["layers"]:
        if "k" in entry:
            return int(entry["k"].shape[1])
    return 0


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = "cuda") -> Dict:
    """Zero cache matching :func:`decode_step`'s expectations (recurrent
    states are float32 whatever ``dtype``, as in the reference, except a
    Mamba layer's conv rows, which take ``dtype``; whisper's attention
    entries add zero (B, enc_frames, Kh, Dh) ``ck``/``cv``)."""
    dev = resolve_device(device)

    def entry(kind: str) -> Dict:
        if kind == "mamba":
            return ssm_lib.mamba_init_state(cfg, batch, dev, dtype)
        if kind in _RECURRENT:
            return _RECURRENT[kind].init_state(cfg, batch, dev)
        e = attn_lib.init_kv_cache(cfg, batch, seq, dtype, dev)
        if cfg.family == "audio":
            cross = attn_lib.init_kv_cache(cfg, batch, cfg.enc_frames,
                                           dtype, dev)
            e["ck"], e["cv"] = cross["k"], cross["v"]
        return e

    return {"layers": [entry(cfg.layer_kind(i))
                       for i in range(cfg.n_layers)]}
