from sfm_jax.cli import main

raise SystemExit(main())
