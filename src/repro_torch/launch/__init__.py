"""Launch layer of the port: the LM training loop (``train.py``) and
serving front end (``serve.py``), the launcher of ranks with the data
mesh's smoke test (``dist_smoke.py``), elastic resume (``elastic.py``),
the paper's DML / IV and sweep workloads as single steps
(``dml_cell.py``, ``sweep_cell.py``), and the production tooling: the
meshes (``mesh.py``), the (arch × shape × mesh) cells (``cells.py``),
the per-device cost counter (``op_cost.py``), the roofline
(``roofline.py``) and the multi-pod dry run (``dryrun.py``).  The
elastic re-mesh and the paper's cell on the production mesh come with
ROADMAP A.14b."""
