"""Mean over the window's steps of the share of routed choices the MoE
layer dropped past capacity (the step's own ``moe_dropped``), in percent."""


def read(run):
    if not run["moe_dropped"]:
        return None
    return 100.0 * sum(run["moe_dropped"]) / len(run["moe_dropped"])
