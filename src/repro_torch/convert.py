"""State of the JAX reference -> the port's state.

The converters take the reference's pytrees with numpy leaves (the caller
applies ``np.asarray`` to every leaf) and return the same structure as
tensors on ``device``: the layout is already the port's, ``(in, out)``
weights and 1-D biases, so nothing is transposed.  Besides the parameters,
the Adam state and a training ring convert, so that both packages can start
a fit from one state.  For the LM, :func:`lm_params_from_numpy`,
:func:`lm_cache_from_numpy` and :func:`train_state_from_numpy` unstack the
reference's scanned layer groups into the port's flat list of layers
(whisper's encoder groups too).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import TrainingCache
from repro_torch.device import DeviceLike, resolve_device


def _tensor(v, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.array(v, np.float32), device=dev)


def enel_params_from_numpy(tree: Mapping, device: DeviceLike = "cuda"
                           ) -> Dict:
    """{"f1".."f4": [{"w", "b"}, ...], "attn_a"} -> the same of tensors."""
    dev = resolve_device(device)
    out: Dict = {}
    for name, val in tree.items():
        if isinstance(val, (list, tuple)):
            layers: List[Dict[str, torch.Tensor]] = [
                {"w": _tensor(l["w"], dev), "b": _tensor(l["b"], dev)}
                for l in val]
            out[name] = layers
        else:
            out[name] = _tensor(val, dev)
    return out


def autoencoder_params_from_numpy(tree: Mapping, device: DeviceLike = "cuda"
                                  ) -> Dict[str, torch.Tensor]:
    """{"enc_w1", "enc_b1", ...} -> the same of tensors."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in tree.items()}


def adam_state_from_numpy(opt: Sequence, device: DeviceLike = "cuda"
                          ) -> Tuple[Dict, Dict, torch.Tensor]:
    """The reference's Adam state ``(mu, nu, t)`` (two parameter pytrees
    and the int32 step count) -> the port's."""
    mu, nu, t = opt
    dev = resolve_device(device)
    return (enel_params_from_numpy(mu, dev), enel_params_from_numpy(nu, dev),
            torch.tensor(np.asarray(t), dtype=torch.int32, device=dev))


def training_cache_from_numpy(buffers: Mapping, *, capacity: int,
                              max_nodes: int, pos: int, count: int,
                              latest, slot_ok, quarantined: int,
                              device: DeviceLike = "cuda"
                              ) -> TrainingCache:
    """A reference ``TrainingCache`` (its buffers as numpy arrays and its
    ring counters) -> the port's ``TrainingCache``."""
    cache = TrainingCache(capacity, max_nodes=max_nodes, device=device)
    cache.buffers = {k: torch.tensor(np.asarray(v), device=cache.device)
                     for k, v in buffers.items()}
    cache.pos = int(pos)
    cache.count = int(count)
    cache.latest = np.asarray(latest, np.int64).copy()
    cache.slot_ok = np.asarray(slot_ok, bool).copy()
    cache.quarantined = int(quarantined)
    return cache


def _lm_tensor(v, dev: torch.device) -> torch.Tensor:
    """A numpy leaf -> a tensor of the same dtype (bfloat16 leaves, which
    numpy holds as ml_dtypes' bfloat16, go through float32 exactly)."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def _lm_tree(tree, dev: torch.device, index=None):
    """Nested dicts of numpy leaves -> the same of tensors, taking
    ``leaf[index]`` of each leaf when ``index`` is given."""
    if isinstance(tree, Mapping):
        return {k: _lm_tree(v, dev, index) for k, v in tree.items()}
    return _lm_tensor(tree if index is None else np.asarray(tree)[index], dev)


def _unstack(groups: Mapping, tail: Sequence, cfg: ModelConfig,
             dev: torch.device) -> List[Dict]:
    """The reference's ``groups`` ({"p0".."p{period-1}"}, each leaf with a
    leading group axis) and ``tail`` list -> one dict per layer, in layer
    order (layer g * period + j is group g's "p{j}")."""
    layers = [_lm_tree(groups[f"p{j}"], dev, g)
              for g in range(cfg.n_groups) for j in range(cfg.layer_period)]
    return layers + [_lm_tree(t, dev) for t in tail]


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device: DeviceLike = "cuda") -> Dict:
    """The reference's ``init_model`` pytree (numpy leaves) -> the port's
    parameters: ``embed``, ``final_norm``, ``unembed`` when untied,
    ``layers`` (whisper's with their ``ln_cross`` / ``cross`` leaves), and
    for whisper ``encoder``: ``{"layers": [...], "final_norm"}``, its
    groups (one layer each, the leading axis ``enc_layers``) unstacked."""
    dev = resolve_device(device)
    out = {k: _lm_tensor(tree[k], dev)
           for k in ("embed", "final_norm", "unembed") if k in tree}
    out["layers"] = _unstack(tree["groups"], tree.get("tail", []), cfg, dev)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_lm_tree(enc["groups"]["p0"], dev, i)
                       for i in range(cfg.enc_layers)],
            "final_norm": _lm_tensor(enc["final_norm"], dev)}
    return out


def lm_cache_from_numpy(cache: Mapping, cfg: ModelConfig,
                        device: DeviceLike = "cuda") -> Dict:
    """The reference's prefill / decode cache (numpy leaves) -> the port's
    ``{"layers": [entry, ...]}``, each entry as the reference keeps it
    (``{k, v}``, whisper's ``{k, v, ck, cv}``, a Mamba layer's ``{h,
    conv}``, ...)."""
    dev = resolve_device(device)
    return {"layers": _unstack(cache["groups"], cache.get("tail", []), cfg,
                               dev)}


def train_state_from_numpy(state: Mapping, cfg: ModelConfig,
                           device: DeviceLike = "cuda") -> Dict:
    """The reference's train state ``{"params", "opt": {"mu", "nu",
    "step"}}`` (numpy leaves) -> the port's: params and both moments
    unstacked into the flat list of layers (and whisper's encoder), each
    leaf in its own dtype;
    ``step`` as an int64 scalar."""
    dev = resolve_device(device)
    opt = state["opt"]
    return {"params": lm_params_from_numpy(state["params"], cfg, dev),
            "opt": {"mu": lm_params_from_numpy(opt["mu"], cfg, dev),
                    "nu": lm_params_from_numpy(opt["nu"], cfg, dev),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int64, device=dev)}}
