"""Frozen copy of ``paper.fig2_timer``: a timer polls, every cycle, the done
signal of a module that writes one item every three cycles."""

def fifos(n: int = 2025):
    return ("result", "done")


def depths(n: int = 2025):
    return (4, 1)


def modules(n: int = 2025):
    def sink():
        for _ in range(n):
            yield "r", "result"

    def compute():
        yield "d", 1
        for k in range(1, n + 1):
            yield "w", "result", k
            if k < n:
                yield "d", 2
        yield "w", "done", 1

    def timer():
        while True:
            ok, _ = yield "rnb", "done"
            if ok:
                break

    return [sink, compute, timer]
