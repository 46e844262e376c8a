"""How a cell drives the port, one module per ``entry`` of a traffic mix.

Each module gives ``Driver(run)`` with ``setup()``, ``window(seconds)``,
``drain()`` and ``close()``; after ``drain()`` its ``record`` (a
:class:`simbench.harness.Record`) holds what the window sent and got back.
"""
