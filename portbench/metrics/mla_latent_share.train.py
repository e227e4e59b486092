"""Latent attention's own work (models/llama.py _latent_qkv, _latent_qk): device time of the operations launched under the port's model.mla.latent (the W_kv_a product, c's norm, the W_kv_b expansion) and model.mla.rope (the rotation of q's and k's rope slices and the assembly of q and k) spans, forward, recompute and backward, over the device's busy time, traced steps."""

from portbench import program_spans

UNIT = "%"
SPANS = ("model.mla.latent", "model.mla.rope")


def read(run):
    return program_spans.share(run, SPANS)
