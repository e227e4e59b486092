"""MoE layer (models/moe.py _route, _moe_mlp): device time of the operations launched under the port's model.moe.* spans (route, dispatch, experts, combine, shared; forward, recompute and backward) over the device's busy time, traced steps."""

from portbench import program_spans

UNIT = "%"
SPANS = ("model.moe.route", "model.moe.dispatch", "model.moe.experts",
         "model.moe.combine", "model.moe.shared")


def read(run):
    return program_spans.share(run, SPANS)
