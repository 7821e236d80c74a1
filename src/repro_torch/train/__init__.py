"""LM training of the port (counterpart of ``repro.train``): AdamW, the
train step, checkpoints, straggler detection and the Enel-driven elastic
trainer."""
