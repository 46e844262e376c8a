"""Frozen copy of ``paper.fig4_ex4b``: as ``fig4_ex4a``; the producer counts
what it drops."""

def fifos(n: int = 2025):
    return ("data",)


def depths(n: int = 2025):
    return (2,)


def modules(n: int = 2025):
    def producer():
        for i in range(1, n + 1):
            yield "wnb", "data", i

    def consumer():
        for _ in range(n):
            yield "rnb", "data"
            yield "d", 2

    return [producer, consumer]
