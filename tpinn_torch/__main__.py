from tpinn_torch.cli import main

main()
