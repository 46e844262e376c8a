"""Frozen copy of ``paper.fig4_ex3``: a controller and a processor in a
cycle of blocking FIFOs."""

def fifos(n: int = 2025):
    return ("cmd", "resp")


def depths(n: int = 2025):
    return (2, 2)


def modules(n: int = 2025):
    def controller():
        for i in range(n):
            yield "w", "cmd", i
            yield "r", "resp"

    def processor():
        for _ in range(n):
            v = yield "r", "cmd"
            yield "w", "resp", 2 * v

    return [controller, processor]
