"""repro_torch.examples — the port's counterparts of the repository's
`examples/` scripts, each run as a module with a size argument:

    python -m repro_torch.examples.quickstart [--rows N] [--device cpu]
    python -m repro_torch.examples.cg_solver [--grid G] [--device cpu]
    python -m repro_torch.examples.moe_reordering [--tokens T] [--device cpu]

Each runs on the card unless it is given `--device cpu`.
"""
