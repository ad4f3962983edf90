"""``batch_wait_ms.train``: the mean host time a traced training step spent
in ``next()`` of the program's TokenPipeline (the harness's span around
it): what the step waited for its batch."""


def read(t):
    waits = t.span_s("next_batch") if t.kind == "train" else []
    return sum(waits) / len(waits) * 1e3 if waits else None
