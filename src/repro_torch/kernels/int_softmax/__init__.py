"""K1: Alg. 1 over the last axis of score rows (port of
``src/repro/kernels/int_softmax``)."""
