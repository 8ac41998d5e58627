"""Launchers of the port: ``serve`` (the multi-tenant serving fleet behind
the hypervisor)."""
