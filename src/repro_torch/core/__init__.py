"""SoftmAP Alg. 1 in PyTorch: precision space, quantizer, integer body, the
float-boundary softmax variants and the softmax dispatcher. Import the
submodules directly (``repro_torch.core.alg1`` ...)."""
