"""K2: fused paged decode attention over a block table (port of
``src/repro/kernels/paged_attention``, dense / GQA layout)."""
