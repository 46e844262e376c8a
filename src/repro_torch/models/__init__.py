"""LM stack of the port (dense family): ``common``, ``mlp``, ``attention``,
``lm``, the family-dispatching ``api`` and ``convert`` (the reference's
weights and decode cache carried across as numpy arrays)."""
