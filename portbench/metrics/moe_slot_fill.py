"""moe_slot_fill: the share of the expert slots that hold a token, in %: the
kept assignments (each routing call's sum over experts of min(choices,
capacity)) over the slots (E x capacity), summed over the ``moe.routing``
counters of the profiled steps (forward and remat's recomputation, which
routes the same). Read from the process-level tracer
(``repro_torch.obs.profiled_tracer``); None where the program has no such
tracer or no routing ran."""

from repro_torch import obs


def read(record):
    tracer = getattr(obs, "profiled_tracer", lambda: None)()
    if record.trace is None or tracer is None:
        return None
    routing = tracer.counter_totals().get("moe.routing")
    if not routing or not routing.get("slots"):
        return None
    return 100.0 * routing["kept"] / routing["slots"]
