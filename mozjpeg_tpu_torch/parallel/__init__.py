"""Multi-device encode: batch sharding (batch.py), iMCU-row sharding of
one image through the full mozjpeg default (rows.py), the same encoders
across processes over torch.distributed (multihost.py), and the dry run
of them all on a small mesh (dryrun.py).

Port of mozjpeg_tpu/parallel/. A mesh is an ordered list of devices
(batch.Mesh); each shard's work runs on its entry's device, stage by
stage over the shards, and the psum of the JAX programs is a sum of the
shards' integer histograms on the first shard's device (and an
all_reduce across processes). Byte-exact contract: every encoder here
gives the bytes of the single-device encoder with the same
configuration (rows.py: with restart_in_rows set to restart_rows).
"""
