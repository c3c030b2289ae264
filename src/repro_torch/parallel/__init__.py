"""Steps and the mesh layer of the port: ``steps`` (one device or a
mesh), ``sharding`` (rules and layouts), ``comm`` (meshes and the
collectives they issue), ``collectives`` and ``pipeline``."""
