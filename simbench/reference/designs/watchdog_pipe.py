"""Frozen copy of ``dynamic.watchdog_pipe``: a blocking pipeline whose sink
signals done, and a watchdog that polls the signal every ``poll_gap``
cycles."""

def fifos(items: int = 2048, stages: int = 4, depth: int = 16,
          poll_gap: int = 64):
    return ("done",) + tuple(f"s{i}" for i in range(stages + 1))


def depths(items: int = 2048, stages: int = 4, depth: int = 16,
           poll_gap: int = 64):
    return (1,) + (depth,) * (stages + 1)


def modules(items: int = 2048, stages: int = 4, depth: int = 16,
            poll_gap: int = 64):
    def watchdog():
        while True:
            ok, _ = yield "rnb", "done"
            if ok:
                break
            yield "d", poll_gap - 1

    def source():
        for _ in range(items):
            yield "w", "s0"

    def make_stage(k: int):
        def stage():
            for _ in range(items):
                yield "r", f"s{k}"
                yield "w", f"s{k + 1}"
        return stage

    def sink():
        for _ in range(items):
            yield "r", f"s{stages}"
        yield "w", "done", 1

    return ([watchdog, source] + [make_stage(k) for k in range(stages)]
            + [sink])
