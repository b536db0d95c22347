"""The host runtime in C++ (``geossl_native.cpp``), bound with ctypes in
``packing.py``: the padded-batch packer, the fused BFS-mask pack, the BFS
subgraph, radius edges and the SDF shard scanner. Built with ``g++`` on
first use; ``GEOSSL_NO_NATIVE=1`` selects the NumPy paths instead."""
