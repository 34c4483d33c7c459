"""Batched immunization on one card (port of ``parallel/``, A.14a): the
sweep's image list (``hosts``) and the batched PGD step (``sweep``).  The
multi-card layouts of the JAX package (reps and images over devices, host
sharding) are not ported yet."""
