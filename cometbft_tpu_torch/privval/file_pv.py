"""FilePV: file-backed validator signer with double-sign protection.

Reference: privval/file.go:157 (FilePV = key file + state file),
:75-100 (FilePVLastSignState: height/round/step + signbytes/signature
memo), :308-370 (signVote/signProposal: refuse to regress HRS; re-serve
the exact previous signature when only the timestamp differs).

The port's copy of the JAX package's privval/file_pv.py. The key and
last-sign-state files are the same JSON, so either package loads the
other's validator home.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

from cometbft_tpu_torch.crypto.keys import PrivKey, PubKey
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.vote import Vote

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {
    canonical.PREVOTE_TYPE: STEP_PREVOTE,
    canonical.PRECOMMIT_TYPE: STEP_PRECOMMIT,
}


class DoubleSignError(Exception):
    pass


class FilePV:
    """PrivValidator (types/priv_validator.go) backed by key+state files."""

    def __init__(self, priv_key: PrivKey, key_path: Optional[str] = None,
                 state_path: Optional[str] = None):
        self.priv_key = priv_key
        self.key_path = key_path
        self.state_path = state_path
        self.height = 0
        self.round = 0
        self.step = 0
        self.sign_bytes: Optional[bytes] = None
        self.signature: Optional[bytes] = None
        self._ext_signature: Optional[bytes] = None
        if state_path and os.path.exists(state_path):
            self._load_state()

    # -- persistence ---------------------------------------------------------

    @staticmethod
    def generate(dirpath: str, seed: Optional[bytes] = None) -> "FilePV":
        os.makedirs(dirpath, exist_ok=True)
        pv = FilePV(
            PrivKey.generate(seed),
            os.path.join(dirpath, "priv_validator_key.json"),
            os.path.join(dirpath, "priv_validator_state.json"),
        )
        pv.save_key()
        pv._save_state()
        return pv

    @staticmethod
    def load(dirpath: str) -> "FilePV":
        key_path = os.path.join(dirpath, "priv_validator_key.json")
        with open(key_path) as f:
            j = json.load(f)
        return FilePV(
            PrivKey(bytes.fromhex(j["priv_key"])),
            key_path,
            os.path.join(dirpath, "priv_validator_state.json"),
        )

    def save_key(self) -> None:
        if not self.key_path:
            return
        with open(self.key_path, "w") as f:
            json.dump({
                "address": self.pub_key().address().hex(),
                "pub_key": self.pub_key().data.hex(),
                "priv_key": self.priv_key.data.hex(),
            }, f)

    def _save_state(self) -> None:
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "height": self.height,
                "round": self.round,
                "step": self.step,
                "sign_bytes": (self.sign_bytes or b"").hex(),
                "signature": (self.signature or b"").hex(),
                "ext_signature": (self._ext_signature or b"").hex(),
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)

    def _load_state(self) -> None:
        with open(self.state_path) as f:
            j = json.load(f)
        self.height = j["height"]
        self.round = j["round"]
        self.step = j["step"]
        self.sign_bytes = bytes.fromhex(j["sign_bytes"]) or None
        self.signature = bytes.fromhex(j["signature"]) or None
        self._ext_signature = bytes.fromhex(
            j.get("ext_signature", "")
        ) or None

    # -- PrivValidator interface ----------------------------------------------

    def pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool = False) -> bytes:
        """Sign a vote with HRS regression protection (file.go:308).

        With `sign_extension` (precommits once extensions are enabled)
        the extension signature is produced too — even for an EMPTY
        extension, since the vote-extension discipline requires a
        signature on every non-nil precommit — and set on the vote in
        place (privval SignVote's signExtension arm)."""
        step = _VOTE_STEP[vote.vote_type]
        self._check_hrs(vote.height, vote.round, step)
        sb = vote.sign_bytes(chain_id)
        # same HRS: only OK if sign bytes identical or only timestamp
        # differs (file.go:330-346) — we require identical here; the
        # consensus engine never re-signs with a new timestamp
        if (self.height, self.round, self.step) == (
            vote.height, vote.round, step
        ):
            if sb == self.sign_bytes:
                # extensions are NOT covered by sb and may differ between
                # retries (the app regenerates them) — re-sign the
                # extension unconditionally; only the vote signature is
                # double-sign-protected (file.go re-signs it too)
                if sign_extension and vote.vote_type == 2:
                    vote.extension_signature = self.priv_key.sign(
                        vote.extension_sign_bytes(chain_id)
                    )
                else:
                    vote.extension_signature = self._ext_signature or b""
                return self.signature
            raise DoubleSignError(
                f"conflicting vote data at {vote.height}/{vote.round}/"
                f"{step}"
            )
        sig = self.priv_key.sign(sb)
        ext_sig = None
        if sign_extension and vote.vote_type == 2:  # PRECOMMIT
            ext_sig = self.priv_key.sign(vote.extension_sign_bytes(chain_id))
            vote.extension_signature = ext_sig
        self.height, self.round, self.step = vote.height, vote.round, step
        self.sign_bytes, self.signature = sb, sig
        self._ext_signature = ext_sig
        self._save_state()
        return sig

    def sign_proposal(self, chain_id: str, height: int, round_: int,
                      pol_round: int, block_id, ts) -> bytes:
        self._check_hrs(height, round_, STEP_PROPOSE)
        sb = canonical.canonical_proposal_bytes(
            chain_id, height, round_, pol_round, block_id, ts
        )
        if (self.height, self.round, self.step) == (
            height, round_, STEP_PROPOSE
        ):
            if sb == self.sign_bytes:
                return self.signature
            raise DoubleSignError(
                f"conflicting proposal data at {height}/{round_}"
            )
        sig = self.priv_key.sign(sb)
        self.height, self.round, self.step = height, round_, STEP_PROPOSE
        self.sign_bytes, self.signature = sb, sig
        self._save_state()
        return sig

    def _check_hrs(self, h: int, r: int, s: int) -> None:
        if (h, r, s) < (self.height, self.round, self.step):
            raise DoubleSignError(
                f"height regression: last signed "
                f"{self.height}/{self.round}/{self.step}, asked {h}/{r}/{s}"
            )
