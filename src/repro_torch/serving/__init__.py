from repro_torch.serving.multitenant import MultiTenantEngine  # noqa: F401
