"""kernel1_row_rounds_per_config: the rows kernel 1's launched rounds
covered, summed over the rounds (the ``row_rounds`` of the
``kernel1.fixpoint`` spans in the traced window, ``simbench/spans.py``; a
4-row group counts 4), over the distinct configurations the window's blocks
solved. Rounds that each cover all K rows of a block read the rounds
launched; rounds that cover only the rows still changing read less. None
where no span carries ``row_rounds``."""

from simbench.spans import placed


def read(run):
    got = placed(run)
    if got is None or run.record.solved <= 0:
        return None
    row_rounds = [s.attrs["row_rounds"] for s, _a, _b in got
                  if s.name == "kernel1.fixpoint" and s.attrs
                  and "row_rounds" in s.attrs]
    if not row_rounds:
        return None
    return sum(row_rounds) / run.record.solved
