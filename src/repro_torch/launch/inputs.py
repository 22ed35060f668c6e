"""input_specs(): stand-ins for every model input of a cell — tensors on the
``meta`` device, which carry shape and dtype and allocate nothing, so full-width
398B parameters and a ``train_4k`` optimizer state cost no memory."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models.model import Model, init_cache, init_params
from ..train.step import TrainConfig, init_train_state

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Training/prefill batch stand-ins. For [vlm] the 256-patch stub is part of the
    sequence budget (text tokens = seq - n_frontend); for [audio] the frames feed the
    encoder and the decoder consumes the full seq."""
    b, s = shape.batch, shape.seq
    out: Dict[str, Any] = {}
    if cfg.frontend == "prefix_embeds":
        s_text = s - cfg.n_frontend
        out["tokens"] = _meta((b, s_text), torch.int32)
        out["labels"] = _meta((b, s_text), torch.int32)
        out["vision_embeds"] = _meta((b, cfg.n_frontend, cfg.d_model), torch.float32)
    elif cfg.frontend == "encoder_frames":
        out["tokens"] = _meta((b, s), torch.int32)
        out["labels"] = _meta((b, s), torch.int32)
        out["frames"] = _meta((b, cfg.n_frontend, cfg.d_model), torch.float32)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
        out["labels"] = _meta((b, s), torch.int32)
    if shape.kind == "prefill":
        out.pop("labels")
    return out


def params_specs(cfg: ArchConfig) -> Model:
    return init_params(cfg, device=META)


def opt_specs(cfg: ArchConfig, tcfg: TrainConfig, params: Model):
    return init_train_state(cfg, tcfg, params)


def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
    """Decode-cell cache stand-ins: a full context of shape.seq tokens."""
    return init_cache(cfg, shape.batch, shape.seq, device=META)


def decode_token_specs(shape: ShapeSpec) -> torch.Tensor:
    return _meta((shape.batch,), torch.int32)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, tcfg: TrainConfig | None = None):
    """Everything the step needs, on the meta device, keyed by step kind."""
    tcfg = tcfg or TrainConfig()
    if shape.kind == "train":
        p = params_specs(cfg)
        return {"params": p, "opt_state": opt_specs(cfg, tcfg, p),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_specs(cfg), "batch": batch_specs(cfg, shape)}
    return {"params": params_specs(cfg), "cache": cache_specs(cfg, shape),
            "tokens": decode_token_specs(shape)}
