"""Steps of the port: ``steps`` (one device); the mesh waits (ROADMAP.md)."""
