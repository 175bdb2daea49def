"""Host-side policies of long runs (ports of ``src/repro/distributed``);
the multi-device layouts are ROADMAP.md Queue 1 item 14."""
