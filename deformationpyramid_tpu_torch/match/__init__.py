"""The learned landmark model of LNDP: the Lepard matcher (KPFCN backbone,
repositioning transformer, dual-softmax matching, soft Procrustes) and the
NeCo outlier rejection, as parameter trees of tensors and pure functions.
Counterpart of ``deformationpyramid_tpu/match/``."""
