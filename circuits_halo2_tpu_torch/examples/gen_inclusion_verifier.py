"""Generate the Solidity inclusion-verifier contract from the VK
(``examples/gen_inclusion_verifier.py``): overflow guard, keygen from the
hermez-raw-11 ceremony file on ``--device``, render the verifier, report
its estimated size.

    python -m circuits_halo2_tpu_torch.examples.gen_inclusion_verifier [--device cpu] [--out DIR]
"""

from ..contracts.sol_generator import SolidityGenerator
from ..contracts.yul_vm import estimate_code_size
from ..utils import pipeline
from . import _common


def main(argv=None) -> str:
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    if pipeline.is_there_risk_of_overflow(_common.N_BYTES, _common.LEVELS):
        raise SystemExit("Risk of overflow in the Merkle root: reduce N_BYTES or LEVELS")
    artifacts = pipeline.generate_setup_artifacts(
        _common.K, str(_common.PTAU), _common.LEVELS, _common.N_CURRENCIES, _common.N_BYTES,
        device=args.device)
    source = SolidityGenerator(artifacts.params, artifacts.vk, 2 + _common.N_CURRENCIES).render()
    out = _common.out_dir(args) / "InclusionVerifier.sol"
    out.write_text(source)
    print(f"Saved {out} ({len(source)} bytes of source)")
    # no solc here: a deterministic instruction-count estimate of the runtime code
    print(f"Estimated verifier runtime code size: {estimate_code_size(source)} bytes "
          "(instruction-count model)")
    return source


if __name__ == "__main__":
    main()
