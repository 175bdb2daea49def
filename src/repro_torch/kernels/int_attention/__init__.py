"""K3: fused prefill attention with the Alg.-1 softmax, a stand-alone op
(port of ``src/repro/kernels/int_attention``; the model does not call it,
as the reference's does not)."""
