"""Multi-device running and host-device overlap (counterpart of
``geossl_tpu/parallel/``): the data mesh and the batch prefetch
(``mesh``), multi-process start-up (``multihost``) and pair-grid
parallelism (``pair_parallel``)."""
