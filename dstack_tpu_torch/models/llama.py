"""Llama-3 family: configuration, parameters and the output head.

Parameters are a plain dictionary of tensors in the same tree and layout
as the JAX package's: stacked layer weights with a leading [L] dim and
matmul weights in ``[in, out]`` layout (``x @ w``).  Keeping the layout
means :func:`params_from_jax` never transposes, and the port's serving
math reads like its reference line for line.  The serving engine walks
the layers with a Python loop over ``w[l]`` views.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from dstack_tpu_torch.ops.rotary import RopeScaling

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500_000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_70b(cls, **kw) -> "LlamaConfig":
        return cls(
            hidden_size=8192, intermediate_size=28_672, num_layers=80,
            num_heads=64, num_kv_heads=8, **kw,
        )

    @classmethod
    def llama3_1b(cls, **kw) -> "LlamaConfig":
        """Llama-3.2-1B shape."""
        return cls(
            hidden_size=2048, intermediate_size=8192, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64, tie_embeddings=True,
            **kw,
        )

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test config: small but structurally faithful (GQA etc.)."""
        return cls(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
            max_seq_len=256, **kw,
        )

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def init_params(cfg: LlamaConfig, device: Union[str, torch.device],
                generator: torch.Generator) -> Params:
    """Scaled-normal init, allocated on ``device`` from ``generator`` (which
    must live on the same device).  Each [in, out] matrix is drawn in f32
    one layer at a time and cast into its stacked ``cfg.dtype`` buffer, so
    an 8B model never exists in f32 or on the host."""
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(shape, fan_in, stacked=True):
        out = torch.empty(((n,) if stacked else ()) + shape,
                          dtype=cfg.dtype, device=device)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       * fan_in ** -0.5)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": dense((cfg.vocab_size, d), d, stacked=False),
        "layers": {
            "attn_norm": ones((n, d)),
            "wq": dense((d, cfg.q_dim), d),
            "wk": dense((d, cfg.kv_dim), d),
            "wv": dense((d, cfg.kv_dim), d),
            "wo": dense((cfg.q_dim, d), cfg.q_dim),
            "mlp_norm": ones((n, d)),
            "w_gate": dense((d, f), d),
            "w_up": dense((d, f), d),
            "w_down": dense((f, d), f),
        },
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), d, stacked=False)
    return params


def output_head(params: Params, cfg: LlamaConfig):
    """[D, V] output projection.  An explicit "lm_head" entry always wins
    (untied models; also the int8 copy of a tied head that
    serving/quant.py makes); tied models use the embedding transpose."""
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T


def params_from_jax(np_tree: Any, device: Union[str, torch.device],
                    dtype: torch.dtype) -> Any:
    """The JAX package's stacked param tree, as numpy arrays, to the port's.

    The layout is kept as it is (``[L, in, out]`` matmul weights — no
    transpose).  Floating leaves become ``dtype``; integer leaves (the
    int8 ``"q"`` of a quantized weight) keep their type, and the f32 ``"s"``
    scales of a quantized dict stay f32."""
    def leaf(a, key=None):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, device=device)
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
        return t if key == "s" else t.to(dtype)

    def walk(node):
        if isinstance(node, dict):
            if "q" in node and "s" in node:
                return {"q": leaf(node["q"]), "s": leaf(node["s"], "s")}
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(np_tree)
