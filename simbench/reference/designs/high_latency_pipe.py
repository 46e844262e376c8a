"""Frozen copy of ``typea.high_latency_pipe``: ``stages`` stages, each
``ii - 2`` cycles of latency between its read and its write."""

def fifos(items: int = 200, stages: int = 6, ii: int = 64):
    return tuple(f"c{i}" for i in range(stages + 1))


def depths(items: int = 200, stages: int = 6, ii: int = 64):
    return (2,) * (stages + 1)


def modules(items: int = 200, stages: int = 6, ii: int = 64):
    def src():
        for _ in range(items):
            yield "w", "c0"

    def make_stage(s: int):
        def stage():
            for _ in range(items):
                yield "r", f"c{s}"
                yield "d", ii - 2
                yield "w", f"c{s + 1}"
        return stage

    def sink():
        for _ in range(items):
            yield "r", f"c{stages}"

    return [src] + [make_stage(s) for s in range(stages)] + [sink]
