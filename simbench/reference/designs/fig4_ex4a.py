"""Frozen copy of ``paper.fig4_ex4a``: non-blocking writes that drop what
does not fit, a consumer that reads non-blocking every third cycle."""

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
