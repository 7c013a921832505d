from h100_bench.run import main

raise SystemExit(main())
