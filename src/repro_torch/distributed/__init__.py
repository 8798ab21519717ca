"""Distribution helpers. Only the bf16 gradient compression is ported; the
shardings and the rest of the reference's `repro.distributed` come with
the launch and distributed modules."""
