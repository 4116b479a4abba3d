"""JSON-RPC HTTP client + RPC-backed light-client provider.

Reference: rpc/jsonrpc/client (HTTP JSON-RPC client) and
light/provider/http (the provider a light client uses to pull
SignedHeader + ValidatorSet over RPC).

The port's copy of the JAX package's rpc/client.py (host code).
"""
from __future__ import annotations

import json
import urllib.request
from typing import Optional

from cometbft_tpu_torch.crypto.keys import PubKey
from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet


class RPCClientError(Exception):
    pass


class HTTPClient:
    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, **params):
        self._id += 1
        req = urllib.request.Request(
            self.base_url,
            data=json.dumps({
                "jsonrpc": "2.0", "id": self._id,
                "method": method, "params": params,
            }).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            j = json.loads(resp.read().decode())
        if "error" in j and j["error"]:
            raise RPCClientError(
                f"{method}: {j['error'].get('message')} "
                f"(code {j['error'].get('code')})"
            )
        return j["result"]

    # convenience wrappers
    def status(self):
        return self.call("status")

    def block(self, height: Optional[int] = None):
        return self.call("block", **(
            {"height": height} if height is not None else {}
        ))

    def commit(self, height: Optional[int] = None):
        return self.call("commit", **(
            {"height": height} if height is not None else {}
        ))

    def validators(self, height: Optional[int] = None,
                   page: Optional[int] = None,
                   per_page: Optional[int] = None):
        params = {}
        if height is not None:
            params["height"] = height
        if page is not None:
            params["page"] = page
        if per_page is not None:
            params["per_page"] = per_page
        return self.call("validators", **params)

    def broadcast_tx_commit(self, tx: bytes):
        import base64

        return self.call("broadcast_tx_commit",
                         tx=base64.b64encode(tx).decode())

    def broadcast_tx_sync(self, tx: bytes):
        import base64

        return self.call("broadcast_tx_sync",
                         tx=base64.b64encode(tx).decode())

    def abci_query(self, data: bytes, path: str = ""):
        return self.call("abci_query", data=data.hex(), path=path)


def light_provider(chain_id: str, base_url: str):
    """light.Provider backed by the RPC /commit + /validators endpoints
    (light/provider/http)."""
    from cometbft_tpu_torch.light import client as lc
    from cometbft_tpu_torch.light import verifier as lv

    http = HTTPClient(base_url)

    def fetch(height: int):
        try:
            cj = http.commit(height)
            # the validators route paginates (max 100/page): walk every
            # page or sets >100 validators would silently truncate and
            # fail the valset-hash check on every header
            rows = []
            page = 1
            while True:
                vj = http.validators(height, page=page, per_page=100)
                rows.extend(vj["validators"])
                if len(rows) >= int(vj["total"]) or not vj["validators"]:
                    break
                page += 1
        except Exception:
            return None
        header = serde.header_from_j(cj["signed_header"]["header"])
        commit = serde.commit_from_j(cj["signed_header"]["commit"])
        vals = ValidatorSet([
            Validator(
                PubKey(bytes.fromhex(v["pub_key"]["value"]),
                       v["pub_key"]["type"]),
                v["voting_power"],
                proposer_priority=v.get("proposer_priority", 0),
            )
            for v in rows
        ])
        return lv.LightBlock(lv.SignedHeader(header, commit), vals)

    return lc.Provider(chain_id, fetch)
