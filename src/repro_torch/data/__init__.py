"""Data of the port: the synthetic corpus (a copy of the reference's) and
document packing."""
