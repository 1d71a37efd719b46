from openmp_parallel_computing_tpu_torch.cli import main

raise SystemExit(main())
