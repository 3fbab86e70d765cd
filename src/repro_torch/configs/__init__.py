"""Model configurations of the port (copies of the JAX package's): the
edge CNN/bert graphs (:mod:`.edge_models`) and the LM substrate's schema
and registry (:mod:`.base`, :mod:`.registry`)."""
