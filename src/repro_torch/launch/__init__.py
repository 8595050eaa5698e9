"""Launchers of the PyTorch port: the step functions (``steps``), the
training CLI (``train``), the serving CLI (``serve``), the trained
artifacts the serving CLI loads (``artifacts``), and the serving mesh
(``mesh``) with its sharding rules (``shardings``)."""
