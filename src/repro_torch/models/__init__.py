"""The LM stack of the port: layers, GQA attention, the Mamba-2 SSD mixer,
the unified transformer (attention and SSD mixers, gated MLPs or none; the
RG-LRU and MoE layers are not ported yet, ROADMAP.md Queue 1 item 6b)."""
