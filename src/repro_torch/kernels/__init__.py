"""Hand-written CUDA kernels of the state-access hot path, for Hopper.

radix_partition — stable within-bucket rank + histogram: the restructure
                  backbone (one launch ranks every interval of a stream)
segscan         — exclusive segmented affine and max scans of the chain
                  coefficients (the staged rung), one launch per scan
megakernel      — fused coefficient / scan / gather / commit evaluation of
                  a stack of intervals, of one problem or of every shard
                  (the megakernel rung)
hash_probe      — key -> slot in a bucketed hash table: the sharded
                  driver's owner lookup under ``use_hash_probe_route``

Each directory holds ``ops.py`` (the wrapper: kernel on a CUDA tensor, twin
on a CPU one) and ``ref.py`` (the plain-PyTorch twin); the CUDA sources are
under ``csrc/`` and build at first use (``_build.py``).
"""
