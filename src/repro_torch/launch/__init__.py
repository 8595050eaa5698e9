"""Launchers of the PyTorch port: the step functions (``steps``), the
training CLI (``train``), the serving CLI (``serve``) and the trained
artifacts the serving CLI loads (``artifacts``). Multi-GPU serving
(a mesh) is not ported yet (ROADMAP A10)."""
