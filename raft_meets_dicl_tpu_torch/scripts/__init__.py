"""Command-line probes of the port (run with ``python -m
raft_meets_dicl_tpu_torch.scripts.<name>``)."""
