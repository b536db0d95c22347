"""Host-device overlap for the drivers (``mesh.prefetch``); the port's
counterpart of ``geossl_tpu/parallel/``."""
