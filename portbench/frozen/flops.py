"""Model operations of a trained step.

What a token needs by the model's definition, not what the program
happens to compute: 2 operations per multiply-add of every weight matrix
the token passes through (a routed layer counts its ``experts_per_token``
experts, not all of them; the embedding lookup counts none), plus
attention's QK and PV over the keys the causal mask keeps.  Padding,
recomputation under remat and the dropped or empty capacity slots of a
dispatch are not model operations.
"""

from __future__ import annotations


def matmul_params(cfg) -> int:
    """Weights a token multiplies, for a port ``LlamaConfig`` or
    ``MoEConfig``."""
    d = cfg.hidden_size
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    experts = getattr(cfg, "experts_per_token", 1)
    mlp = 3 * d * cfg.intermediate_size * experts
    router = d * getattr(cfg, "num_experts", 0)
    return cfg.num_layers * (attn + mlp + router) + d * cfg.vocab_size


def train_step_flops(cfg, batch: int, seq: int) -> int:
    """One training step on ``batch`` rows of ``seq`` tokens: 6 operations
    per weight per token (forward and backward), and attention's 14 * D
    per kept (query, key) pair per head and layer (forward QK and PV;
    backward five products)."""
    pairs = batch * seq * (seq + 1) // 2
    return (6 * matmul_params(cfg) * batch * seq
            + 14 * cfg.head_dim * pairs * cfg.num_heads * cfg.num_layers)
