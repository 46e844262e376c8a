"""Frozen copy of ``paper.deadlock``: two modules that each read the other
first."""

def fifos(n: int = 2025):
    return ("a2b", "b2a")


def depths(n: int = 2025):
    return (2, 2)


def modules(n: int = 2025):
    def task_a():
        for i in range(n):
            yield "r", "b2a"
            yield "w", "a2b", i

    def task_b():
        for i in range(n):
            yield "r", "a2b"
            yield "w", "b2a", i

    return [task_a, task_b]
