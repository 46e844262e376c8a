"""Frozen copy of ``paper.multicore``: a dispatcher, ``cores`` fetcher and
executor pairs as in ``branch``, and a collector (34 modules and 64 FIFOs at
the defaults)."""

SENTINEL = -1


def fifos(cores: int = 16, prog_len: int = 128, stride: int = 8):
    return tuple(f"{kind}{c}" for kind in ("work", "instr", "redirect",
                                           "result") for c in range(cores))


def depths(cores: int = 16, prog_len: int = 128, stride: int = 8):
    return (2,) * cores + (4,) * cores + (2,) * cores + (2,) * cores


def modules(cores: int = 16, prog_len: int = 128, stride: int = 8):
    def dispatcher():
        for c in range(cores):
            yield "w", f"work{c}", prog_len + c * stride

    def make_fetcher(c: int):
        def fetcher():
            limit = yield "r", f"work{c}"
            pc = fetched = 0
            while pc < limit:
                ok, target = yield "rnb", f"redirect{c}"
                if ok:
                    pc = target
                yield "w", f"instr{c}", pc
                fetched += 1
                pc += 1
            yield "w", f"instr{c}", SENTINEL
            yield "w", f"instr{c}", fetched
        return fetcher

    def make_executor(c: int):
        def executor():
            expected = executed = 0
            while True:
                pc = yield "r", f"instr{c}"
                if pc == SENTINEL:
                    fetched = yield "r", f"instr{c}"
                    break
                if pc != expected:
                    continue
                executed += 1
                if pc % stride == 0:
                    expected = pc + stride // 2
                    yield "wnb", f"redirect{c}", expected
                else:
                    expected = pc + 1
            yield "w", f"result{c}", fetched
            yield "w", f"result{c}", executed
        return executor

    def collector():
        for c in range(cores):
            yield "r", f"result{c}"
            yield "r", f"result{c}"

    bodies = [dispatcher]
    for c in range(cores):
        bodies += [make_fetcher(c), make_executor(c)]
    return bodies + [collector]
