"""K2 and K4: fused paged decode attention over a block table (port of
``src/repro/kernels/paged_attention``: the dense / GQA layout and the
absorbed-MLA layout)."""
