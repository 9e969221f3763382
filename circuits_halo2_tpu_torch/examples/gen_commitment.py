"""Generate the on-chain commitment calldata for a CSV snapshot
(``examples/gen_commitment.py``): build the Merkle sum tree of
``entry_16.csv`` on ``--device`` and export ``(root_hash, root_balances)``
as Solidity calldata JSON.

    python -m circuits_halo2_tpu_torch.examples.gen_commitment [--device cpu] [--out DIR]
"""

import json

from ..merkle.mst import MerkleSumTree
from ..utils.pipeline import field_element_to_solidity_calldata
from . import _common


def main(argv=None) -> dict:
    args = _common.parser(__doc__.splitlines()[0]).parse_args(argv)
    tree = MerkleSumTree.from_csv(str(_common.CSV_DIR / "entry_16.csv"), args.device)
    data = {
        "root_hash": field_element_to_solidity_calldata(tree.root.hash),
        "root_balances": [field_element_to_solidity_calldata(b) for b in tree.root.balances],
    }
    out = _common.out_dir(args) / "commitment_solidity_calldata.json"
    out.write_text(json.dumps(data))
    print(f"wrote {out}: {data}")
    return data


if __name__ == "__main__":
    main()
