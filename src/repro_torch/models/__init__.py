"""The LM stack of the port: layers, GQA attention, the unified transformer
(dense attention mixers with gated MLPs; the SSD, RG-LRU and MoE mixers
are not ported yet, ROADMAP.md Queue 1 item 6)."""
