"""Command-line launchers of the port (``serve``, ``train``), its meshes
(``mesh``) and the shape-only structures of every cell (``specs``)."""
