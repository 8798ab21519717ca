"""repro_torch.bench — the paper's figure and table drivers on the port.

Each module is a thin view over `repro_torch.experiments`, the port's
counterpart of the module of the same name under the repository's
`benchmarks/`: the same spec (matrices, schemes, engines, kinds, variants,
policy), the same CSV file name, header and row order, and the same keys
in its returned summary. Every driver measures on the card unless it is
given device="cpu"; those that read a matrix tier take `matrices=` to run
on fewer matrices. `run.py` is the orchestrator:

    python -m repro_torch.bench.run [--quick] [--only fig03_ios_yax,...]
    python -m repro_torch.bench.run --smoke [--device cpu]
    python -m repro_torch.bench.run --smoke-parallel [--device cpu]

CSVs and the result store go to common.results_dir().
"""
