from blackbox_mpc_torch.cli import main

raise SystemExit(main())
