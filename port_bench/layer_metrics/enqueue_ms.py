"""Host time of one ``step_fn`` call, before the loss is read: the host
enqueueing the train step (the benchmark's ``step_fn`` span, host clock,
taken in the untraced pass that precedes the profiled one)."""


def read(t):
    ds = t.host.get("step_fn")
    return sum(ds) / len(ds) * 1e3 if ds else None
