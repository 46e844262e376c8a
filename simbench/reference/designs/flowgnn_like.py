"""Frozen copy of ``typea.flowgnn_like``: a loader, a gather and an update
stage per layer (the update with one cycle of latency), and a readout."""

def fifos(n_nodes: int = 128, layers: int = 4):
    return tuple(f"h{i}" for i in range(2 * layers + 1))


def depths(n_nodes: int = 128, layers: int = 4):
    return (8,) * (2 * layers + 1)


def modules(n_nodes: int = 128, layers: int = 4):
    def loader():
        for _ in range(n_nodes):
            yield "w", "h0"

    def make_gather(layer: int):
        def gather():
            for _ in range(n_nodes):
                yield "r", f"h{2 * layer}"
                yield "w", f"h{2 * layer + 1}"
        return gather

    def make_update(layer: int):
        def update():
            for _ in range(n_nodes):
                yield "r", f"h{2 * layer + 1}"
                yield "d", 1
                yield "w", f"h{2 * layer + 2}"
        return update

    def readout():
        for _ in range(n_nodes):
            yield "r", f"h{2 * layers}"

    bodies = [loader]
    for layer in range(layers):
        bodies += [make_gather(layer), make_update(layer)]
    return bodies + [readout]
