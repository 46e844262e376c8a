"""Frozen copy of ``paper.fig4_ex2``: a producer polls a done signal and
writes non-blocking until it lands; the consumer sums ``n`` items."""

def fifos(n: int = 2025):
    return ("data", "done")


def depths(n: int = 2025):
    return (2, 1)


def modules(n: int = 2025):
    items = list(range(1, n + 1)) + [0] * (3 * n)

    def producer():
        i = 0
        while True:
            ok, _ = yield "rnb", "done"
            if ok:
                break
            ok = yield "wnb", "data", items[i]
            if ok:
                i += 1

    def consumer():
        for _ in range(n):
            yield "r", "data"
        yield "w", "done", 1

    return [producer, consumer]
