"""Frozen copy of ``paper.fig4_ex4b_d``: as ``fig4_ex4a_d``; the producer
counts what it drops."""

def fifos(n: int = 2025):
    return ("data", "done")


def depths(n: int = 2025):
    return (2, 1)


def modules(n: int = 2025):
    items = list(range(1, n + 1)) + [0] * (6 * n)

    def producer():
        i = 0
        while True:
            ok, _ = yield "rnb", "done"
            if ok:
                break
            yield "wnb", "data", items[i]
            i += 1

    def consumer():
        for _ in range(n):
            yield "rnb", "data"
            yield "d", 2
        yield "w", "done", 1

    return [producer, consumer]
