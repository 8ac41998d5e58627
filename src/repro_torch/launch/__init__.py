"""Launchers of the port: ``serve`` (the multi-tenant serving fleet behind
the hypervisor) and ``train`` (AdamW on the synthetic token pipeline, with
checkpoints)."""
