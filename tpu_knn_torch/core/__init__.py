"""Host layer: errors, params, registries, data store."""
