"""Distribution layer of the PyTorch port: the simulated inter-shard
transport, heartbeat and straggler health, and the int8 wire codec that
the sharded segment store rides (``serve/shard_store.py``)."""
