"""The LM stack of the port: layers, GQA attention, the Mamba-2 SSD mixer,
the RG-LRU block, the MoE layer (one device; expert parallelism waits for
ROADMAP.md Queue 1 item 7) and the unified transformer."""
