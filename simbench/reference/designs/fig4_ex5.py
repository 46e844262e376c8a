"""Frozen copy of ``paper.fig4_ex5``: a controller probes whether the slow
processor's FIFO is full and sends each item to it or to the fast one."""

SENTINEL = -1


def fifos(n: int = 2025):
    return ("to_p1", "to_p2")


def depths(n: int = 2025):
    return (2, 2)


def modules(n: int = 2025):
    def controller():
        for i in range(1, n + 1):
            full = yield "full", "to_p1"
            yield "w", ("to_p2" if full else "to_p1"), i
        yield "w", "to_p1", SENTINEL
        yield "w", "to_p2", SENTINEL

    def p1():
        while (yield "r", "to_p1") != SENTINEL:
            yield "d", 2

    def p2():
        while (yield "r", "to_p2") != SENTINEL:
            pass

    return [controller, p1, p2]
