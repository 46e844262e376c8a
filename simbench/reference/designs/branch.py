"""Frozen copy of ``paper.branch``: an executor redirects its fetcher by a
non-blocking write; the fetcher polls for it before every fetch."""

SENTINEL = -1


def fifos(prog_len: int = 1024, stride: int = 16):
    return ("instr", "redirect")


def depths(prog_len: int = 1024, stride: int = 16):
    return (4, 2)


def modules(prog_len: int = 1024, stride: int = 16):
    def fetcher():
        pc = 0
        while pc < prog_len:
            ok, target = yield "rnb", "redirect"
            if ok:
                pc = target
            yield "w", "instr", pc
            pc += 1
        yield "w", "instr", SENTINEL

    def executor():
        expected = 0
        while True:
            pc = yield "r", "instr"
            if pc == SENTINEL:
                break
            if pc != expected:
                continue
            if pc % stride == 0:
                expected = pc + stride // 2
                yield "wnb", "redirect", expected
            else:
                expected = pc + 1

    return [fetcher, executor]
