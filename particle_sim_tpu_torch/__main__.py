"""``python -m particle_sim_tpu_torch`` runs the headless CLI (app/cli.py)."""

from .app.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
