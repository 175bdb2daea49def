"""Training of the port: loss, AdamW, bf16 gradient compression, the train
step (ports of ``src/repro/training``)."""
