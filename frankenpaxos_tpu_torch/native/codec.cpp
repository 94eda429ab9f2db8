// Native wire codec for the transport hot path (the port's copy of
// frankenpaxos_tpu/native/codec.cpp, byte-for-byte the same code).
//
// The reference's only performance-critical native-adjacent component is
// its Netty NIO TCP stack (SURVEY.md section 0; build.sbt:31): framing and
// byte shuffling on the JVM's native transport. This is our equivalent:
// a small C++ library (loaded via ctypes) implementing
//
//   * length-prefixed frame encoding/decoding compatible with
//     runtime/tcp_transport.py's format:
//       [u32 total][u32 header_len][header "host:port"][payload]
//     including batch encoding (coalesce many frames into one write
//     buffer, the send_no_flush/flush path), and
//
//   * the Phase2b vote-batch codec: pack/unpack arrays of
//     (slot, acceptor, round) int32 triples -- the wire format that feeds
//     TpuQuorumChecker.record_and_check without any per-message Python
//     object churn.
//
// Build: g++ -O3 -shared -fPIC codec.cpp -o libfpxcodec-<hash>.so, done at
// first use by native/__init__.py into native/_build/ (keyed by a hash of
// this source).

#include <cstdint>
#include <cstring>

namespace {

inline void put_u32_be(uint8_t* p, uint32_t x) {
  p[0] = static_cast<uint8_t>(x >> 24);
  p[1] = static_cast<uint8_t>(x >> 16);
  p[2] = static_cast<uint8_t>(x >> 8);
  p[3] = static_cast<uint8_t>(x);
}

inline uint32_t get_u32_be(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

constexpr uint32_t kMaxFrame = 10 * 1024 * 1024;  // NettyTcpTransport's cap

}  // namespace

extern "C" {

// Encode one frame into `out`. Returns bytes written, or -1 if `out_cap`
// is too small, or -2 if the frame would exceed the 10 MiB cap.
long long fpx_encode_frame(const uint8_t* header, uint32_t header_len,
                           const uint8_t* payload, uint32_t payload_len,
                           uint8_t* out, uint64_t out_cap) {
  const uint64_t inner = 4ull + header_len + payload_len;
  const uint64_t total = 4ull + inner;
  if (inner > kMaxFrame) return -2;
  if (total > out_cap) return -1;
  put_u32_be(out, static_cast<uint32_t>(inner));
  put_u32_be(out + 4, header_len);
  std::memcpy(out + 8, header, header_len);
  std::memcpy(out + 8 + header_len, payload, payload_len);
  return static_cast<long long>(total);
}

// Coalesce `n` frames (shared header) into one buffer. `payloads` is a
// contiguous blob; `payload_lens[i]` gives each payload's length. Returns
// total bytes written or -1/-2 as above.
long long fpx_encode_frames(const uint8_t* header, uint32_t header_len,
                            const uint8_t* payloads,
                            const uint32_t* payload_lens, uint32_t n,
                            uint8_t* out, uint64_t out_cap) {
  uint64_t written = 0;
  uint64_t offset = 0;
  for (uint32_t i = 0; i < n; ++i) {
    long long r =
        fpx_encode_frame(header, header_len, payloads + offset,
                         payload_lens[i], out + written, out_cap - written);
    if (r < 0) return r;
    written += static_cast<uint64_t>(r);
    offset += payload_lens[i];
  }
  return static_cast<long long>(written);
}

// Scan `buf` for complete frames. Writes up to `max_frames` (start, end)
// byte offsets of each frame's inner region (header_len prefix included)
// into `offsets` (2 entries per frame). Returns the number of complete
// frames found; `*consumed` is set to the end of the last complete frame.
long long fpx_scan_frames(const uint8_t* buf, uint64_t len,
                          uint64_t* offsets, uint32_t max_frames,
                          uint64_t* consumed) {
  uint64_t pos = 0;
  uint32_t found = 0;
  while (found < max_frames && pos + 4 <= len) {
    const uint32_t inner = get_u32_be(buf + pos);
    if (inner > kMaxFrame) return -2;
    if (pos + 4 + inner > len) break;
    offsets[2 * found] = pos + 4;
    offsets[2 * found + 1] = pos + 4 + inner;
    pos += 4ull + inner;
    ++found;
  }
  *consumed = pos;
  return found;
}

// --- paxwire batch frames ---------------------------------------------------
// A batch frame coalesces a drain's same-type messages to one peer into
// ONE wire frame. Its payload is
//   [0x00][batch tag - 128][u32le count][count * u32le seg_len][segments]
// (the leading two bytes are a normal extended-page wire tag, so the
// frame-layer lane classifier in serve/lanes.py reads batch frames like
// any other codec'd message -- no decode needed to shed or spare them).
// The segments are the messages' ordinary wire payloads, copied raw: a
// run/reply-array whose value bytes are LazyValueArray segments is
// batched without ever re-materializing a value.

// Write the batch payload HEADER (escape, tag byte, count, lens) in one
// call -- the vectorized replacement for count * struct.pack on the hot
// flush path. Returns bytes written or -1 if out_cap is too small.
long long fpx_batch_header(uint8_t tag_byte, const uint32_t* seg_lens,
                           uint32_t n, uint8_t* out, uint64_t out_cap) {
  const uint64_t total = 2ull + 4ull + 4ull * n;
  if (total > out_cap) return -1;
  out[0] = 0;  // extended-page escape
  out[1] = tag_byte;
  std::memcpy(out + 2, &n, 4);  // little-endian like every codec field
  std::memcpy(out + 6, seg_lens, 4ull * n);
  return static_cast<long long>(total);
}

// Scan a batch payload's segment table. `buf` points AT the u32 count
// (the 0x00 + tag bytes already consumed); writes (start, end) offsets
// relative to `buf` into `offsets` (2 per segment). Returns the segment
// count, or -1 if the table is malformed (count/lens exceeding `len` --
// the containment contract: a torn or hostile batch frame must fail
// validation here, before any consumer trusts a length).
long long fpx_scan_batch(const uint8_t* buf, uint64_t len,
                         uint64_t* offsets, uint32_t max_segs) {
  if (len < 4) return -1;
  uint32_t n;
  std::memcpy(&n, buf, 4);
  if (n > max_segs) return -1;
  if (4ull + 4ull * n > len) return -1;
  uint64_t at = 4ull + 4ull * n;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t seg_len;
    std::memcpy(&seg_len, buf + 4 + 4ull * i, 4);
    if (at + seg_len > len) return -1;
    offsets[2 * i] = at;
    offsets[2 * i + 1] = at + seg_len;
    at += seg_len;
  }
  if (at != len) return -1;  // trailing garbage = torn/corrupt frame
  return n;
}

// --- paxingest: wire-to-run-pipeline column scan ----------------------------
// The zero-object decode path (frankenpaxos_tpu/ingest/, docs/TRANSPORT.md):
// a ClientFrameBatch arriving on the wire scans ONCE into SoA columns and
// the run pipeline's value-array segment, so no per-message Python object
// (Command/ClientRequest/CommandId) ever materializes between recv() and
// the leader's Phase2aRun.
//
// Input: the batch payload with the two leading tag bytes consumed (`buf`
// points AT the u32 segment count, exactly like fpx_scan_batch). Every
// segment must be a client-write payload, either shape:
//   tag 4 (ClientRequest):
//     [0x04][address][i64 pseudonym][i64 client_id][u32 len][cmd bytes]
//   tag 115 (ClientRequestArray -- the coalescing client's shape; ONE
//   address covers all its commands):
//     [0x73][address][i32 n][n * (i64 pseudonym, i64 id, u32 len, bytes)]
//   address = [u8 kind][u32 len][bytes]([i32 port] when kind == 1)
//
// Output:
//   * `out` receives the RUN-PIPELINE VALUE ARRAY segment -- the exact
//     byte layout multipaxos/wire.py's _put_value_array produces for a
//     one-CommandBatch-per-command run (deduped address table in
//     first-seen order, then per-command bodies). A LazyValueArray over
//     these bytes re-encodes as a raw copy all the way to the acceptors.
//   * `cols` receives n rows of 5 int64 columns: (addr_idx, pseudonym,
//     client_id, value_off, value_len), value offsets ABSOLUTE into
//     `buf` -- the descriptor the reply path consumes without decoding.
//
// Returns the command count; -1 = malformed (torn/corrupt -- the caller
// surfaces ValueError through the transport's corrupt-frame guard);
// -2 = out_cap too small; -3 = well-formed but unsupported shape (mixed
// tags, exotic address kind, trailing bytes): the caller falls back to
// the ordinary per-message decode, which defines the semantics.

namespace {
constexpr uint32_t kMaxIngestAddrs = 4096;
}

long long fpx_ingest_scan(const uint8_t* buf, uint64_t len, uint8_t* out,
                          uint64_t out_cap, uint64_t* out_len,
                          int64_t* cols, uint32_t max_cmds) {
  if (len < 4) return -1;
  uint32_t n;
  std::memcpy(&n, buf, 4);
  // Corruption checks strictly before shape checks (the Python
  // fallback mirrors this order bit-for-bit).
  if (4ull + 4ull * n > len) return -1;
  if (n > max_cmds) return -3;
  // Segment table (same validation contract as fpx_scan_batch).
  uint64_t at = 4ull + 4ull * n;
  // Pass A: validate every segment, dedup addresses by raw bytes.
  uint64_t addr_off[kMaxIngestAddrs];
  uint64_t addr_len[kMaxIngestAddrs];
  uint32_t n_addrs = 0;
  uint64_t table_bytes = 0;
  uint64_t body_bytes = 0;
  uint64_t seg_at = at;
  uint64_t cmds = 0;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t seg_len;
    std::memcpy(&seg_len, buf + 4 + 4ull * i, 4);
    if (seg_at + seg_len > len) return -1;
    const uint8_t* seg = buf + seg_at;
    if (seg_len < 2) return -1;
    const uint8_t tag = seg[0];
    if (tag != 4 && tag != 115) return -3;  // not a client write
    const uint8_t kind = seg[1];
    if (seg_len < 1 + 5) return -1;
    uint32_t alen;
    std::memcpy(&alen, seg + 2, 4);
    uint64_t a_end = 1ull + 5ull + alen;  // past [kind][len][bytes]
    if (kind == 1) {
      a_end += 4;  // [i32 port]
    } else if (kind != 0 && kind != 2) {
      return -3;  // unknown address kind: let Python decode decide
    }
    if (a_end > seg_len) return -1;
    // Dedup the address raw bytes [1, a_end).
    const uint64_t araw_len = a_end - 1;
    uint32_t idx = n_addrs;
    for (uint32_t a = 0; a < n_addrs; ++a) {
      if (addr_len[a] == araw_len
          && std::memcmp(buf + addr_off[a], seg + 1, araw_len) == 0) {
        idx = a;
        break;
      }
    }
    if (idx == n_addrs) {
      if (n_addrs == kMaxIngestAddrs) return -3;
      addr_off[n_addrs] = seg_at + 1;
      addr_len[n_addrs] = araw_len;
      table_bytes += araw_len;
      ++n_addrs;
    }
    uint64_t entry_at;   // first (pseudonym, id, len, bytes) entry
    uint64_t n_entries;
    if (tag == 4) {
      entry_at = a_end;
      n_entries = 1;
    } else {
      if (a_end + 4 > seg_len) return -1;
      uint32_t k;
      std::memcpy(&k, seg + a_end, 4);
      entry_at = a_end + 4;
      n_entries = k;
    }
    for (uint64_t e = 0; e < n_entries; ++e) {
      if (entry_at + 20 > seg_len) return -1;
      uint32_t vlen;
      std::memcpy(&vlen, seg + entry_at + 16, 4);
      if (entry_at + 20ull + vlen > seg_len) return -1;
      if (cmds == max_cmds) return -3;
      // body entry: [u8 1][i32 1][i32 idx][i64 pseudonym][i64 id]
      //             [u32 vlen][payload]
      body_bytes += 1 + 4 + 20 + 4 + vlen;
      cols[5ull * cmds + 0] = idx;
      int64_t pseudonym, client_id;
      std::memcpy(&pseudonym, seg + entry_at, 8);
      std::memcpy(&client_id, seg + entry_at + 8, 8);
      cols[5ull * cmds + 1] = pseudonym;
      cols[5ull * cmds + 2] = client_id;
      cols[5ull * cmds + 3] =
          static_cast<int64_t>(seg_at + entry_at + 20);
      cols[5ull * cmds + 4] = vlen;
      ++cmds;
      entry_at += 20ull + vlen;
    }
    if (entry_at != seg_len) return -3;  // trailing bytes
    seg_at += seg_len;
  }
  if (seg_at != len) return -1;  // trailing garbage = torn/corrupt
  const uint64_t total = 4 + table_bytes + body_bytes;
  if (total > out_cap) return -2;
  // Pass B: write [i32 t][addresses][bodies].
  std::memcpy(out, &n_addrs, 4);
  uint64_t w = 4;
  for (uint32_t a = 0; a < n_addrs; ++a) {
    std::memcpy(out + w, buf + addr_off[a], addr_len[a]);
    w += addr_len[a];
  }
  const uint32_t one = 1;
  for (uint64_t i = 0; i < cmds; ++i) {
    out[w] = 1;
    std::memcpy(out + w + 1, &one, 4);
    const uint32_t idx = static_cast<uint32_t>(cols[5ull * i + 0]);
    std::memcpy(out + w + 5, &idx, 4);
    std::memcpy(out + w + 9, &cols[5ull * i + 1], 8);
    std::memcpy(out + w + 17, &cols[5ull * i + 2], 8);
    const uint32_t vlen = static_cast<uint32_t>(cols[5ull * i + 4]);
    std::memcpy(out + w + 25, &vlen, 4);
    std::memcpy(out + w + 29, buf + cols[5ull * i + 3], vlen);
    w += 29ull + vlen;
  }
  *out_len = w;
  return static_cast<long long>(cmds);
}

// Columns from a VALUE-ARRAY raw segment (LazyValueArray.raw: the layout
// fpx_ingest_scan emits and _put_value_array writes). Supports exactly
// the ingest-plane shape -- every entry a one-command CommandBatch --
// and returns -3 for anything else (noops, multi-command batches) so
// consumers fall back to the decoding path. Value offsets are ABSOLUTE
// into `buf`. `n` is the declared entry count (LazyValueArray.n).
long long fpx_value_columns(const uint8_t* buf, uint64_t len, int64_t* cols,
                            uint32_t max_cmds, uint32_t n) {
  if (len < 4 || n > max_cmds) return n > max_cmds ? -3 : -1;
  uint32_t t;
  std::memcpy(&t, buf, 4);
  uint64_t at = 4;
  // Walk the address table to find where bodies start.
  for (uint32_t a = 0; a < t; ++a) {
    if (at + 5 > len) return -1;
    const uint8_t kind = buf[at];
    uint32_t alen;
    std::memcpy(&alen, buf + at + 1, 4);
    at += 5ull + alen;
    if (kind == 1) at += 4;
    else if (kind != 0 && kind != 2) return -3;
    if (at > len) return -1;
  }
  for (uint32_t i = 0; i < n; ++i) {
    if (at + 1 > len) return -1;
    if (buf[at] != 1) return -3;  // noop or exotic value
    if (at + 5 > len) return -1;
    uint32_t k;
    std::memcpy(&k, buf + at + 1, 4);
    if (k != 1) return -3;  // multi-command batch
    if (at + 5 + 20 + 4 > len) return -1;
    uint32_t idx;
    std::memcpy(&idx, buf + at + 5, 4);
    if (idx >= t) return -1;
    int64_t pseudonym, client_id;
    std::memcpy(&pseudonym, buf + at + 9, 8);
    std::memcpy(&client_id, buf + at + 17, 8);
    uint32_t vlen;
    std::memcpy(&vlen, buf + at + 25, 4);
    if (at + 29ull + vlen > len) return -1;
    cols[5ull * i + 0] = idx;
    cols[5ull * i + 1] = pseudonym;
    cols[5ull * i + 2] = client_id;
    cols[5ull * i + 3] = static_cast<int64_t>(at + 29);
    cols[5ull * i + 4] = vlen;
    at += 29ull + vlen;
  }
  if (at != len) return -1;
  return n;
}

// --- paxfan reply columns (ingest/columns.py, docs/TRANSPORT.md) -----------
// A ClientReplyArray payload's entries as SoA columns -- the RETURN-path
// twin of fpx_ingest_scan. ``buf`` starts at the i32 entry count (the
// leading tag byte already consumed by the caller). Entry layout
// (protocols/multipaxos/wire.py ClientReplyArrayCodec, tag 118):
//   [i64 pseudonym][i64 client_id][i64 slot][u32 result_len][result]
// cols rows are (pseudonym, client_id, slot, result_off, result_len),
// offsets relative to ``buf``. Returns n >= 0 on success, -1 on a
// torn/corrupt payload, -2 when the count exceeds the caller's cap.
long long fpx_reply_columns(const uint8_t* buf, uint64_t len, int64_t* cols,
                            uint32_t cap) {
  if (len < 4) return -1;
  int32_t n_signed;
  std::memcpy(&n_signed, buf, 4);
  if (n_signed < 0) return -1;
  const uint32_t n = static_cast<uint32_t>(n_signed);
  // Every entry consumes >= 28 bytes, so a count past len / 28 is torn
  // regardless of cap -- checked BEFORE the cap so hostile counts are
  // corruption, not a silent fallback.
  if (4ull + 28ull * n > len) return -1;
  if (n > cap) return -2;
  uint64_t at = 4;
  for (uint32_t i = 0; i < n; ++i) {
    if (at + 28 > len) return -1;
    int64_t pseudonym, client_id, slot;
    std::memcpy(&pseudonym, buf + at, 8);
    std::memcpy(&client_id, buf + at + 8, 8);
    std::memcpy(&slot, buf + at + 16, 8);
    uint32_t rlen;
    std::memcpy(&rlen, buf + at + 24, 4);
    if (at + 28ull + rlen > len) return -1;
    cols[5ull * i + 0] = pseudonym;
    cols[5ull * i + 1] = client_id;
    cols[5ull * i + 2] = slot;
    cols[5ull * i + 3] = static_cast<int64_t>(at + 28);
    cols[5ull * i + 4] = rlen;
    at += 28ull + rlen;
  }
  if (at != len) return -1;
  return n;
}

// --- Phase2b vote-batch codec ---------------------------------------------
// Wire layout: [u32 count][count * (i32 slot, i32 node, i32 round)] with
// little-endian fixed-width ints (the host side hands these straight to
// TpuQuorumChecker as numpy arrays).

long long fpx_pack_votes(const int32_t* slots, const int32_t* nodes,
                         const int32_t* rounds, uint32_t n, uint8_t* out,
                         uint64_t out_cap) {
  const uint64_t total = 4ull + 12ull * n;
  if (total > out_cap) return -1;
  std::memcpy(out, &n, 4);
  int32_t* p = reinterpret_cast<int32_t*>(out + 4);
  for (uint32_t i = 0; i < n; ++i) {
    p[3 * i] = slots[i];
    p[3 * i + 1] = nodes[i];
    p[3 * i + 2] = rounds[i];
  }
  return static_cast<long long>(total);
}

// Returns the vote count, filling the three output arrays (each with
// capacity `cap`), or -1 on malformed input.
long long fpx_unpack_votes(const uint8_t* buf, uint64_t len, int32_t* slots,
                           int32_t* nodes, int32_t* rounds, uint32_t cap) {
  if (len < 4) return -1;
  uint32_t n;
  std::memcpy(&n, buf, 4);
  if (len < 4ull + 12ull * n || n > cap) return -1;
  const int32_t* p = reinterpret_cast<const int32_t*>(buf + 4);
  for (uint32_t i = 0; i < n; ++i) {
    slots[i] = p[3 * i];
    nodes[i] = p[3 * i + 1];
    rounds[i] = p[3 * i + 2];
  }
  return n;
}

// Two-column variant for SINGLE-acceptor batches (Phase2bVotes): the
// acceptor's identity travels in the message header, so packing a node
// column would ship 4 dead bytes per vote. Slots are i64 like every
// other slot on the wire (Phase2b/Phase2bRange carry '<q' slots); a
// 12-byte packed record, memcpy'd because entries are unaligned.
// Wire layout: [u32 count][count * (i64 slot, i32 round)].
long long fpx_pack_votes2(const int64_t* slots, const int32_t* rounds,
                          uint32_t n, uint8_t* out, uint64_t out_cap) {
  const uint64_t total = 4ull + 12ull * n;
  if (total > out_cap) return -1;
  std::memcpy(out, &n, 4);
  uint8_t* p = out + 4;
  for (uint32_t i = 0; i < n; ++i) {
    std::memcpy(p, &slots[i], 8);
    std::memcpy(p + 8, &rounds[i], 4);
    p += 12;
  }
  return static_cast<long long>(total);
}

long long fpx_unpack_votes2(const uint8_t* buf, uint64_t len,
                            int64_t* slots, int32_t* rounds, uint32_t cap) {
  if (len < 4) return -1;
  uint32_t n;
  std::memcpy(&n, buf, 4);
  if (len < 4ull + 12ull * n || n > cap) return -1;
  const uint8_t* p = buf + 4;
  for (uint32_t i = 0; i < n; ++i) {
    std::memcpy(&slots[i], p, 8);
    std::memcpy(&rounds[i], p + 8, 4);
    p += 12;
  }
  return n;
}

}  // extern "C"
