"""Pair-parallel and intra-pair sharded execution over ``torch.distributed``
ranks, one card a rank. Counterpart of ``deformationpyramid_tpu/parallel/``."""
