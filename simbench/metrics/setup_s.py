"""setup_s: from the start of ``simbench/run.py`` to the end of the warm-up
(host clock): imports, the CUDA context, the design's initial simulation and
compiled graph, the kernel library's build where none is there yet, and one
warm-up request of each size the window sends."""


def read(run):
    return run.setup_s
