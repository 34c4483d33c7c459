"""Immunization over ranks and batches (port of ``parallel/``): the
mesh of ranks (``mesh``), EOT reps over ranks (``eot``), images x reps
(``dp_eot``), the sweep's image list and its split over machines
(``hosts``) and the batched step (``sweep``)."""
