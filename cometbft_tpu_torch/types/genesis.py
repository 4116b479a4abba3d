"""Genesis document: the file format a testnet boots from.

Reference: types/genesis.go (GenesisDoc with chain_id, genesis_time,
initial_height, consensus_params, validators, app_hash, app_state;
SaveAs/GenesisDocFromFile + ValidateAndComplete).

The port's copy of the JAX package's types/genesis.py: the same JSON
file format, so one genesis file boots either package.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto.keys import PubKey
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet


class GenesisError(Exception):
    pass


@dataclass
class GenesisValidator:
    pub_key: PubKey
    power: int
    name: str = ""


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Timestamp = field(default_factory=Timestamp)
    initial_height: int = 1
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: Optional[dict] = None
    consensus_params: ConsensusParams = field(
        default_factory=ConsensusParams
    )

    def validate(self) -> None:
        """ValidateAndComplete (types/genesis.go:60)."""
        if not self.chain_id:
            raise GenesisError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > 50:
            raise GenesisError("chain_id in genesis doc is too long")
        if self.initial_height < 1:
            raise GenesisError("initial_height must be >= 1")
        for v in self.validators:
            if v.power < 0:
                raise GenesisError(
                    f"validator {v.name!r} has negative voting power"
                )

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet(
            [Validator(v.pub_key, v.power) for v in self.validators]
        )

    def make_state(self) -> State:
        self.validate()
        return State.make_genesis(
            self.chain_id, self.validator_set(),
            app_hash=self.app_hash,
            initial_height=self.initial_height,
            genesis_time=self.genesis_time,
            params=self.consensus_params,
        )

    # -- file format -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "chain_id": self.chain_id,
            "genesis_time": {"seconds": self.genesis_time.seconds,
                             "nanos": self.genesis_time.nanos},
            "initial_height": self.initial_height,
            "validators": [
                {
                    "address": v.pub_key.address().hex().upper(),
                    "pub_key": {"type": v.pub_key.key_type,
                                "value": v.pub_key.data.hex()},
                    "power": v.power,
                    "name": v.name,
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex(),
            "app_state": self.app_state,
            "consensus_params": self.consensus_params.to_j(),
        }, indent=2)

    def save_as(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def from_file(path: str) -> "GenesisDoc":
        with open(path) as f:
            j = json.load(f)
        doc = GenesisDoc(
            chain_id=j["chain_id"],
            genesis_time=Timestamp(j["genesis_time"]["seconds"],
                                   j["genesis_time"]["nanos"]),
            initial_height=j.get("initial_height", 1),
            validators=[
                GenesisValidator(
                    PubKey(bytes.fromhex(v["pub_key"]["value"]),
                           v["pub_key"]["type"]),
                    v["power"], v.get("name", ""),
                )
                for v in j.get("validators", [])
            ],
            app_hash=bytes.fromhex(j.get("app_hash", "")),
            app_state=j.get("app_state"),
            consensus_params=ConsensusParams.from_j(
                j.get("consensus_params")
            ),
        )
        doc.validate()
        return doc
