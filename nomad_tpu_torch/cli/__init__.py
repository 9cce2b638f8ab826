"""L7 CLI."""
