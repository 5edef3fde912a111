"""Launch layer of the port: the LM serving driver (``serve.py``) and the
launcher of ranks with the data mesh's smoke test (``dist_smoke.py``).
The reference's mesh, dry-run, roofline and train drivers come with
ROADMAP A.13f and A.14."""
