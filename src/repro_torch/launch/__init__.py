"""Launch layer of the port: the LM serving driver (``serve.py``), the
launcher of ranks with the data mesh's smoke test (``dist_smoke.py``),
elastic resume of a sweep (``elastic.py``), and the paper's DML / IV and
sweep workloads as single steps (``dml_cell.py``, ``sweep_cell.py``).
The reference's mesh, dry-run, cost, roofline and train drivers come
with ROADMAP A.13f and A.14."""
