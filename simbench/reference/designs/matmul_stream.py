"""Frozen copy of ``typea.matmul_stream``: a streaming matmul of the Vitis
examples (A and B feeders into a MAC engine, then a drain)."""

def fifos(m: int = 16, k: int = 16, n: int = 16):
    return ("a", "b", "c")


def modules(m: int = 16, k: int = 16, n: int = 16):
    def feed_a():
        for _i in range(m):
            for _p in range(k):
                yield "w", "a"

    def feed_b():
        for _i in range(m):            # B re-streamed per row of A
            for _p in range(k):
                for _j in range(n):
                    yield "w", "b"

    def mac():
        for _i in range(m):
            for _p in range(k):
                yield "r", "a"
                for _j in range(n):
                    yield "r", "b"
            for _j in range(n):
                yield "w", "c"

    def drain():
        for _ in range(m * n):
            yield "r", "c"

    return [feed_a, feed_b, mac, drain]
